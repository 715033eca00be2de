// The flash forward at head dim 256 (flash_fwd.cuh; see flash_attention.cu).
#include "flash_fwd.cuh"

template <>
int flash_fwd_launch<256>(const FwdArgs& a) {
  return launch<256>(a);
}
