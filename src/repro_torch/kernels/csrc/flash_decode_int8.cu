// Kernel 6's decode form over an int8 KV cache (decode_span_kernel with
// int8 codes and fp32 scales, decode_merge_kernel, and their C launchers
// flash_decode_scratch_floats and flash_decode_int8_launch):
// csrc/flash_attention.cu, where the design is set out, compiled with
// FLASH_DECODE and FLASH_DECODE_INT8 defined, as a library of its own that
// nvcc builds beside the other forms'.
#define FLASH_DECODE 1
#define FLASH_DECODE_INT8 1
#include "flash_attention.cu"
