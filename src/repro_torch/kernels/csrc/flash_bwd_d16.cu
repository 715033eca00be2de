// The flash backward at head dim 16 (flash_bwd.cuh; see
// flash_attention_bwd.cu).
#include "flash_bwd.cuh"

template <>
int flash_bwd_launch<16>(const BwdArgs& a) {
  return bwd_launch<16>(a);
}
