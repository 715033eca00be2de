// Flash attention (forward) for Hopper (sm_90a): bf16 on the tensor cores
// through `wgmma`, float32 on the CUDA cores.  The C entry points; the
// kernels are in flash_fwd.cuh, compiled once a head dim in
// flash_fwd_d<D>.cu so the build runs them in parallel.
//
// Replaces: src/repro/kernels/flash_attention.py, `_flash_kernel`, reached
// through `flash_attention` (and `ops.attention`): tiled online-softmax
// attention, causal and sliding-window masks by index, GQA by index mapping
// (q head h reads kv head h / rep), float32 running max, denominator and
// accumulator, output in q's dtype.
//
// Semantics shared by both kernels: masked scores are -1e30, as in the TPU
// kernel, so a row with no key in its band keeps the reference's uniform
// average; keys past S weigh exactly 0 (any T and S work); the result is
// divided by max(l, 1e-30) (the bf16 kernel multiplies by its reciprocal).
// Tiles wholly outside the causal or window band are skipped only when
// every row of the q tile has some key in the band: their weights are
// then exactly zero, so the result is unchanged.  The q tiles run
// heaviest (latest) first.
//
// What bounds it on the H100: at the long prefills (h2o-danube's q
// (4,8192,32,80) under a window of 4,096, gemma3's (4,4096,8|16,256),
// mixtral's, arctic's, zamba2's) the band's products are 0.28-2.5 ms of
// bf16 tensor-core work at 989 TFLOP/s against 0.02-0.3 ms of bytes, so
// the tensor cores bound it; at the llama prefill shape (q (4,512,32,64))
// bytes and operations are close (6.3 and 4.3 us).  The sm_80 design
// before this one (`mma.sync` 16 x 8 products, `cp.async`, 4 warps over
// 64 rows) reached 23-25% of that bound: each warp's mma -> softmax -> mma
// chain and two CTA barriers a tile held it, not its loads.  This one
// reaches 40-56% of it at those shapes (H100 80GB HBM3, 700 W;
// scripts/flash_bf16_variants.py).  What holds it now is the consumers'
// own work, not the loads (without the K/V loads past the ring's first
// fill it is 5-8% faster): at D = 80 a consumer warp spends ~1,330 of
// ~2,600 SM cycles a 128-key tile in the softmax, whose 64 exponentials
// a thread share the special-function unit with the other consumer's,
// and ~810 issuing its products behind the other's (`--phases`).
//
// bf16, the serving path (`flash_bf16_kernel<D, kCap>`):
// - a CTA owns a 128-row q tile of one (batch, head): warpgroups 0 and 1
//   are the consumers, 64 rows each (`wgmma`'s M), and warpgroup 2 the
//   producer.  The producer gives up its registers (`setmaxnreg` 24) and
//   the consumers take them (240): 384 x 168 at the launch, one CTA an
//   SM.  (A wait that trapped after a timeout, anywhere in the kernel,
//   kept ptxas at 168 registers in the consumers and serialised their
//   `wgmma`s at D = 128 and 256; the waits do not time out.)  The q tiles
//   of one (batch, head) are consecutive CTAs, heaviest first, so the 132
//   CTAs on the card at once read few heads' K and V, which stay in L2;
// - one producer thread issues every load through the TMA: the q tile
//   once, then K and V tile by tile (128 keys; 80 at D = 256) into a ring
//   of 3 shared-memory stages (2 at D = 256: 226 KB there, 229 KB at
//   D = 128), K and V each completing on its own full `mbarrier` and the
//   stage freed by one empty `mbarrier`, so S starts once K has landed.
//   The tensor maps are 4-D, (D, H, T, B) for q and (D, KV, S, B) for k
//   and v, built on the host at each launch (`cuTensorMapEncodeTiled`,
//   found through the runtime): a box never crosses into the next batch
//   or head, and rows past T or S arrive as zeros;
// - S = Q K^T is `wgmma.m64nTKk16` with Q and K both K-major in swizzled
//   shared memory, one descriptor pair a 16-column step.  The softmax runs
//   in base 2 on the accumulator, whose layout (rows l/4 and l/4 + 8 of
//   each warp's 16, columns 8j + 2(l%4) + {0,1}) is `mma.sync`'s, so the
//   masks, the softcap and the online softmax are the earlier kernel's.
//   A tile that needs no mask keeps its raw scores and takes 1/sqrt(D)
//   log2(e) with the exponent's subtraction in one FFMA; a masked tile is
//   scaled first, so a masked score is -1e30 in base 2 exactly;
// - O += P V takes P from registers: S rounded to bf16 in place is the A
//   operand (`wgmma` RS), V the B operand, MN-major (the transpose flag of
//   16-bit types), one `wgmma.m64nDk16` over all of D where D is 64-column
//   chunks only (64, 128, 256: the chunks a leading byte offset apart, P
//   read from the registers once), else one a chunk.  That rounding of P
//   (2^-9 relative a weight) is the only one the bf16 path adds to the
//   reference's arithmetic;
// - overlap: up to D = 128 each consumer issues S of tile j + 1 and
//   O += P V of tile j together and runs the softmax of j + 1 while P V
//   runs (P is packed to bf16 only after that P V is done, since `wgmma`
//   reads its registers asynchronously), and the two consumers take
//   turns to issue (named barriers), so one's softmax runs under the
//   other's products.  At D = 256 a consumer waits for each of its
//   products and the consumers do not take turns (S, P and O of two
//   tiles at once, and the turns, were slower there);
// - only the tiles the band's edge or S crosses are masked element by
//   element; the band is aligned to the key tile;
// - the epilogue scales O by 1 / l once (a division an element made it a
//   third of the kernel at the short prefills), writes lse and the
//   float32 O from the fragments as before, and O in bf16 through the
//   warpgroup's own rows of the q tile (its swizzle kept, so the 4-byte
//   writes fall in distinct banks), 16 bytes a lane to global memory.
//
// Head dims.  The TMA and `wgmma` read a tile in column chunks: 64
// columns in 128-byte rows with 128-byte swizzle, then a tail of 16
// columns (32-byte rows and swizzle) or 32 (64-byte), each chunk its own
// tensor map box and descriptors.  So D = 64, 128, 256 are 1, 2, 4 chunks,
// D = 16 and 32 one tail (the same kernel serves the small cases), and
// D = 80 (h2o-danube, zamba2) is a 64-column chunk plus a 16-column tail:
// its 5 k-steps of S are 4 128-byte-swizzle steps and 1 32-byte one, and
// its P V is an n64 and an n16 `wgmma` a key step, so no column is padded
// (padding to 96 or 128 would add 20-60% to both products).  D = 256
// keeps 128 floats of O, 40 of S and 20 of P a thread under the 240.
//
// Training (`flash_attention_lse_launch`): the same kernels also write each
// row's log-sum-exp of the masked scaled scores, lse (B,H,T) float32, which
// the backward kernels (flash_attention_bwd.cu) read to recompute P.  A row
// with no key in its band gets lse = -1e30 (the mask value) exactly, the
// backward's sign for "every key weighs 1/S".  The bf16 kernel also writes
// the float32 output (the accumulator over l, before its rounding to bf16)
// where it is given an `o32` pointer: the backward's D = rowsum(dO * O)
// from the bf16 output moved dQ and dK by up to 0.005 of their scale, past
// the 2^-8 tolerance, on non-causal attention.  It costs 4 bytes an output
// element written, beside the 2 of the bf16 output.  `flash_attention_launch`
// passes no lse and no o32 pointer, and the serving path is unchanged.
//
// Softcap (gemma3's option; 0 = off): each scaled score s becomes
// c tanh(s / c) in float32 (`tanhf`) before the mask, as in the JAX
// package's plain attention; the bf16 kernel then multiplies by log2(e)
// for its base-2 softmax, and lse is the natural-log lse of the capped
// scores.  The bf16 kernel takes it as a template flag (`kCap`), each head
// dim built with and without, so the uncapped kernel carries no tanh code.
// The float32 kernel takes it at run time.
//
// float32 (`flash_f32_kernel`), what the per-layer route checks compute:
// one CTA owns one (batch x head, 64-row q tile), one thread per query row
// (up to D = 128), and loops over 32-key tiles loaded coalesced into
// shared memory, read by every thread as a broadcast.  The q row is held
// pre-scaled by 1/sqrt(D) in registers with its float32 accumulator, max
// and denominator (read from shared memory at D = 128, `kQInRegs`).  At
// D = 256 4 threads share a q row (`kFSplit`), each owning every 4th
// float4 of the head dim, their partial dot products summed by
// `__shfl_xor_sync`.  TF32 tensor cores would keep 10 bits of the
// mantissa, too few for the float32 checks, so this path stays on the CUDA
// cores.
#include <cuda_runtime.h>

#include "flash_fwd.cuh"

namespace {

int launch_dim(int head_dim, const FwdArgs& a) {
  switch (head_dim) {
    case 16:
      return flash_fwd_launch<16>(a);
    case 32:
      return flash_fwd_launch<32>(a);
    case 64:
      return flash_fwd_launch<64>(a);
    case 80:
      return flash_fwd_launch<80>(a);
    case 128:
      return flash_fwd_launch<128>(a);
    case 256:
      return flash_fwd_launch<256>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,T,H,D), k/v (B,S,KV,D), o (B,T,H,D), all contiguous and of one dtype
// (is_bf16 ? bfloat16, 16-byte aligned : float32).  window <= 0 means none;
// softcap <= 0 means none.  Returns the cudaGetLastError() of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int t_len, int s_len, int n_heads,
                                      int n_kv, int head_dim, int causal,
                                      int window, int is_bf16, float scale,
                                      float softcap, void* stream) {
  return launch_dim(head_dim,
                    FwdArgs{q, k, v, o, nullptr, nullptr, batch, t_len, s_len,
                            n_heads, n_kv, causal, window, is_bf16, scale,
                            softcap, (cudaStream_t)stream});
}

// The same launch, also writing lse (B,H,T) float32 (contiguous): the
// training forward, whose backward is flash_attention_bwd_launch.  With
// bf16 inputs, o32 (B,T,H,D) float32 (contiguous), if not null, receives
// the output before its rounding to bf16; float32 inputs ignore it.
extern "C" int flash_attention_lse_launch(const void* q, const void* k,
                                          const void* v, void* o, void* o32,
                                          void* lse, int batch, int t_len,
                                          int s_len, int n_heads, int n_kv,
                                          int head_dim, int causal, int window,
                                          int is_bf16, float scale,
                                          float softcap, void* stream) {
  return launch_dim(head_dim,
                    FwdArgs{q, k, v, o, (float*)o32, (float*)lse, batch, t_len,
                            s_len, n_heads, n_kv, causal, window, is_bf16,
                            scale, softcap, (cudaStream_t)stream});
}
