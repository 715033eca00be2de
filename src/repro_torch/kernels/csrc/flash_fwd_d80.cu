// The flash forward at head dim 80 (flash_fwd.cuh; see flash_attention.cu).
#include "flash_fwd.cuh"

template <>
int flash_fwd_launch<80>(const FwdArgs& a) {
  return launch<80>(a);
}
