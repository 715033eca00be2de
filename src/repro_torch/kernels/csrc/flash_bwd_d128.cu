// The flash backward at head dim 128 (flash_bwd.cuh; see
// flash_attention_bwd.cu).
#include "flash_bwd.cuh"

template <>
int flash_bwd_launch<128>(const BwdArgs& a) {
  return bwd_launch<128>(a);
}
