// Flash attention backward for Hopper (sm_90a): dQ, dK, dV from q, k, v, the
// forward's output o, its log-sum-exp lse and the upstream gradient dO.
// The C entry point; the kernels are in flash_bwd.cuh, compiled once a head
// dim in flash_bwd_d<D>.cu so the build runs them in parallel.
//
// The backward of: flash_attention.cu (`flash_attention_lse_launch`), the
// port of src/repro/kernels/flash_attention.py `_flash_kernel`.  The JAX
// package has no backward kernel (it differentiates plain jnp); this is how
// the port computes what `jax.value_and_grad` computes there, and
// kernels/ref.py `attention_bwd` is its plain version:
//
//   P  = exp(S - lse), S = scale q k^T masked as in the forward
//   D  = rowsum(dO * O)                                  (dot kernel)
//   dV = sum over the group's q heads of P^T dO          (dK/dV kernel)
//   dS = P * (dO v^T - D), 0 where the mask holds
//   dK = scale dS^T q                                    (dK/dV kernel)
//   dQ = scale dS k                                      (dQ kernel)
//
// O is the forward's output in q's dtype or in float32: the training
// forward hands the bf16 path its float32 output (before the rounding to
// bf16), since D from the rounded O moved dQ and dK by up to 0.005 of
// their scale on non-causal attention, past the 2^-8 tolerance.  A row
// with no key in its band (lse == -1e30) weighs every key 1/S in dV and
// passes no gradient to its scores, as the forward's uniform average.
// Keys past S and rows past T weigh 0.
//
// What bounds it on the H100: at the llama3.2-1b train shape (q
// (4,512,32,64), k/v (4,512,8,64), bf16, causal) it must read q, k, v, o,
// dO (21 MB with lse and D) and write dq, dk, dv (12.6 MB): 10 us at
// 3.35 TB/s; it does 10 flops a head dim per unmasked pair (QK^T, dO V^T,
// P^T dO, dS^T Q, dS K), 10.8 GFLOP, 11 us on the bf16 tensor cores.  At
// the long training shapes (h2o-danube's (1,8192,32,80) under a window of
// 4,096, gemma3-4b's (1,4096,8,256), mixtral's, zamba2's) the products
// are 4-15 times the bytes' time: the tensor cores bound it.  The kernels
// issue 20 flops a head dim and pair, not 10: the separate dQ kernel
// recomputes S and dP (the price of writing every output once, with no
// atomics, so the backward is deterministic and a resumed run repeats its
// loss bit for bit), and P and dS enter their products as two bf16 terms
// each (below).  So half the bound is the ceiling of this design.
//
// bf16, the training path (`flash_bwd_dkdv_bf16_kernel<D, PASS, kCap>`,
// `flash_bwd_dq_bf16_kernel<D, kCap>`), on the forward's machinery
// (flash_fwd.cuh, hopper.cuh): `wgmma` fed by TMA, warp-specialised.  A CTA
// is two consumer warpgroups and a producer warpgroup (384 threads); the
// producer gives up its registers (`setmaxnreg` 24) and the consumers take
// them (240); one CTA an SM.  One producer thread issues every load through
// the TMA, into a ring of stages that complete on `mbarrier`s; the tensor
// maps are the forward's 4-D ones, (D, H, T, B) for q and dO and
// (D, KV, S, B) for k and v, so rows past T or S arrive as zeros.  Every
// product is one of the forward's two shapes on the same layouts, so none
// needs a transpose in memory:
// - S^T = K Q^T, dP^T = V dO^T (dK/dV) and S = Q K^T, dP = dO V^T (dQ) are
//   `wgmma` with A and B K-major in swizzled shared memory, as the
//   forward's S (`issue_ss`);
// - dV += P^T dO, dK += dS^T Q and dQ += dS K take A from registers, the
//   accumulator of P^T, dS^T or dS in the A layout, and B MN-major, as the
//   forward's O += P V (`issue_rs2`).
// P and dS enter their products as TWO bf16 terms each, hi = bf16(x) and
// lo = bf16(x - hi), two `wgmma`s into one accumulator: one bf16 rounding
// of P puts dV at up to 0.0065 of its scale from the float32 reference,
// and one of dS puts dQ at up to 0.007 (dS sums to ~0 over a row's keys,
// so dQ cancels), both past the 2^-8 the gradients are held to; hi + lo
// keeps ~16 bits, and every gradient stays within 0.0025 (a CPU model of
// this arithmetic, tests/test_torch_flash_bwd_wgmma.py).  With the
// rounding of the gradients at the store, these are the only changes to
// the reference's float32 arithmetic.
// - dK/dV: one CTA a (b, kv head, 64-key tile), the key tiles major and
//   the first (under a causal band the heaviest: the first key tile walks
//   every q tile, the last one) first.  The keys are `wgmma`'s 64 rows; K
//   and V load once.  The walk is the group's H/KV q heads (GQA summed
//   inside the CTA) and the band's q tiles of kBwdN rows (64; 32 at
//   D = 256), their Q and dO through a ring of 3 stages.  The two
//   consumers take every other tile of the walk, each into its own dK and
//   dV, and at the end consumer 1 hands its sums to consumer 0 through the
//   consumed stages, which adds them in that order: a fixed order, no
//   atomics.  So a 64-key tile's walk takes both consumers, and the card
//   holds twice the CTAs of 128-key ones: gemma3-4b's 4,096 keys over 4
//   KV heads are 256 CTAs, heaviest first: the heaviest spans 94% of the
//   launch, yet the busiest SM's summed CTA time is within 2% of the mean
//   SM's there and at the other long training shapes (13-19% at gemma3's
//   local layer), so no walk is split over two CTAs.
//   Each consumer copies its next tile's lse and D rows into its own
//   double buffer (`cp.async`, arriving on an `mbarrier`) while it
//   computes this one.  Per tile: S^T, dP^T; P^T = 2^(S^T scale log2(e) -
//   lse log2(e)); dS^T = P^T (dP^T - D); dV += P^T dO and dK += dS^T Q
//   (dV's product issued before dS^T's terms are made); dK is scaled in
//   float32 at the store.  A thread holds 64 keys x D of dK and dV over
//   the warpgroup (D/2 floats each), S^T and dP^T (kBwdN/2 each) and the
//   terms.  At D = 256 the two accumulators alone would be 256 floats a
//   thread, so the kernel runs as two launches, a dV pass and a dK pass
//   (`DkdvPass`), each holding one and recomputing S^T (22 flops a head
//   dim and pair in all, against 20).
// - dQ: one CTA a (b, head, 128-row q tile), the q tiles major and the
//   last (the heaviest) first; each consumer owns 64 rows, Q and dO load
//   once, the band's K/V tiles of kBwdN keys stream through a ring of 3
//   stages.  Per tile: S, dP; dS = P (dP - D); dQ += dS K, scaled at the
//   store.  A tile with no kept pair for a consumer's rows is skipped by
//   it (causal: the diagonal tile's upper half).
// Only the tiles the band's edge (or T, or S in the dQ kernel) crosses are
// masked element by element, and those take their own copy of the
// elementwise loop: predicated into every tile, the mask code had doubled
// it.  The tiles walked hold every weighted pair.  Each consumer waits
// for its products (S and dP, then the two-term gradients) before it goes
// on; the two consumers of a CTA overlap each other.  (Overlapping a
// consumer's own softmax with its previous tile's products, as the
// forward does, was slower here: its S and dP then queue behind the other
// consumer's products.)  Shared memory: K and V (dK/dV) or Q and dO (dQ)
// and the rings, 132 KB (dK/dV) and 162 KB (dQ) at D = 128, 163 and
// 226 KB at D = 256.  ptxas: no spills and no serialised `wgmma` at any
// head dim.
//
// What holds it (scripts/bwd_variants.py --phases, H100): at the long
// shapes the products (issued, waited for, behind the other consumer's)
// take about half of a consumer's cycles a tile; the rest is the
// elementwise work (exponentials, masks, the two bf16 terms) and, in the
// dK/dV kernel, the walk's bookkeeping.  The two consumers keep the
// tensor cores about half busy: 14.7-30.3% of the bound by CUDA events,
// 1.3-2.3x the kernels this design replaced.  The second bf16 term costs
// 11-30% (the `flash_1term` variant).  PERF.md section 6 has the table.
//
// Head dims: the TMA and `wgmma` read a tile in the forward's column
// chunks, 64 columns with a 128-byte swizzle and a tail of 16 or 32, so
// D = 80 (h2o-danube, zamba2) is 64 + 16 and D = 16, 32 are one tail, with
// no column padded.
//
// Softcap (gemma3's option, 0 = off): S is recomputed capped,
// c tanh(s / c) with s the scaled score (`tanhf`), P from it, and
// dS = P (dP - D) (1 - tanh^2) takes the cap's derivative.  The bf16
// kernels take it as a template flag (`kCap`), each built with and
// without, so the uncapped kernels carry no tanh code (a runtime branch
// once cost the llama shape's backward 14%).  The float32 kernels take it
// at run time.
//
// float32 (`flash_bwd_dkdv_kernel`, `flash_bwd_dq_kernel`), what the
// per-layer and whole-step route checks compute: on the CUDA cores, the
// products in full float32.
// - dK/dV: one CTA per (batch, kv head, 64-key tile; 16 at D = 256,
//   `kTile`).  Each key is owned by
//   D/16 neighbouring threads, 16 head dims each (4 of 20 at D = 80,
//   `kSlice`), holding its k and v
//   slices and its dK and dV accumulators in registers; the two dot
//   products of a (query, key) pair are summed over those threads by
//   `__shfl_xor_sync`.  The CTA loops over the group's H/KV query heads
//   (GQA is summed inside the CTA) and over the 32-row (16 at D = 256,
//   `kStep`) q tiles that the causal/window band reaches (or that hold a
//   row with no key in its band), staging q (pre-scaled), dO, lse and D in
//   shared memory, read by every thread as broadcasts.
// - dQ: one CTA per (batch, head, 64-row q tile; 16 at D = 256), the same
//   layout with rows in place of keys, looping over the 32-key (16) tiles
//   of the band.
//   At D = 256, 64 keys of 16 lanes would be 1,024 threads of at most 64
//   registers, and 32-row stages 64 KB of static shared memory: hence the
//   16-key (16-row) CTAs of 256 threads and the 16-row (16-key) stages.
// - D = rowsum(dO * O): one warp a row (both types).
#include <cuda_runtime.h>

#include "flash_bwd.cuh"

namespace {

int launch_dim(int head_dim, const BwdArgs& a) {
  switch (head_dim) {
    case 16:
      return flash_bwd_launch<16>(a);
    case 32:
      return flash_bwd_launch<32>(a);
    case 64:
      return flash_bwd_launch<64>(a);
    case 80:
      return flash_bwd_launch<80>(a);
    case 128:
      return flash_bwd_launch<128>(a);
    case 256:
      return flash_bwd_launch<256>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout, dq (B,T,H,D); k, v, dk, dv (B,S,KV,D), all contiguous and of
// one dtype (is_bf16 ? bfloat16, 16-byte aligned : float32); o (B,T,H,D)
// contiguous, float32 if o_f32 (as it always is with float32 inputs), else
// bfloat16; lse and dsum (B,H,T) float32, dsum scratch that the launch
// fills.  window <= 0 means none; softcap <= 0 means none.  Three kernels
// on `stream` (four at D = 256 in bf16: the dot kernel, the dK/dV kernel's
// dV and dK passes, the dQ kernel); returns the first cudaGetLastError()
// that is not 0.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dsum, int batch, int t_len, int s_len, int n_heads, int n_kv,
    int head_dim, int causal, int window, int is_bf16, int o_f32,
    float scale, float softcap, void* stream) {
  return launch_dim(head_dim,
                    BwdArgs{q, k, v, o, lse, dout, dq, dk, dv, (float*)dsum,
                            batch, t_len, s_len, n_heads, n_kv, causal,
                            window, is_bf16, is_bf16 ? o_f32 : 1, scale,
                            softcap, (cudaStream_t)stream});
}
