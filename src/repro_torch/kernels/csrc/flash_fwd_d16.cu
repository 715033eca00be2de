// The flash forward at head dim 16 (flash_fwd.cuh; see flash_attention.cu).
#include "flash_fwd.cuh"

template <>
int flash_fwd_launch<16>(const FwdArgs& a) {
  return launch<16>(a);
}
