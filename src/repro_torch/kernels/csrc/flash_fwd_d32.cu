// The flash forward at head dim 32 (flash_fwd.cuh; see flash_attention.cu).
#include "flash_fwd.cuh"

template <>
int flash_fwd_launch<32>(const FwdArgs& a) {
  return launch<32>(a);
}
