// The flash forward at head dim 128 (flash_fwd.cuh; see flash_attention.cu).
#include "flash_fwd.cuh"

template <>
int flash_fwd_launch<128>(const FwdArgs& a) {
  return launch<128>(a);
}
