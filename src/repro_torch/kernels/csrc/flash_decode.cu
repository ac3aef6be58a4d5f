// Kernel 6's decode form (decode_span_kernel and decode_merge_kernel, with
// their C launchers flash_decode_scratch_floats and flash_decode_launch):
// csrc/flash_attention.cu, where the design is set out, compiled with
// FLASH_DECODE defined, as a library of its own that nvcc builds beside the
// prefill forms'.
#define FLASH_DECODE 1
#include "flash_attention.cu"
