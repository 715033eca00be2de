// The flash forward at head dim 64 (flash_fwd.cuh; see flash_attention.cu).
#include "flash_fwd.cuh"

template <>
int flash_fwd_launch<64>(const FwdArgs& a) {
  return launch<64>(a);
}
