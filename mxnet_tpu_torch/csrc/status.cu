// Message for a status returned by one of the kernel entry points.
#include "common.cuh"

extern "C" const char* mxtt_error_string(int code) {
  if (code == MXTT_BAD_ARGUMENT) return "unsupported shape or dtype";
  if (code == MXTT_TENSOR_MAP)
    return "cuTensorMapEncodeTiled unavailable or refused the operand";
  return cudaGetErrorString((cudaError_t)code);
}
