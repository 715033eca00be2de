// The flash backward at head dim 32 (flash_bwd.cuh; see
// flash_attention_bwd.cu).
#include "flash_bwd.cuh"

template <>
int flash_bwd_launch<32>(const BwdArgs& a) {
  return bwd_launch<32>(a);
}
