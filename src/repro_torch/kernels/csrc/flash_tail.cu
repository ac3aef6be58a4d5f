// Kernel 6's tail form (flash_kernel and flash_mma_kernel with kTail, and
// their C launcher flash_tail_launch): csrc/flash_attention.cu, where the
// design is set out, compiled with FLASH_TAIL defined, as a library of its
// own that nvcc builds beside the full prefill's.  A tail prefill's queries
// sit at per-row offsets over a prefix restored into the ring cache (the
// prefix cache's hit rows); its key tiles run over absolute positions from
// 0, so each row sums what a full prefill of the whole prompt sums there,
// in the same order.
#define FLASH_TAIL 1
#include "flash_attention.cu"
