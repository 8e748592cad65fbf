// Message for a status returned by one of the kernel entry points.
#include "common.cuh"

extern "C" const char* mxtt_error_string(int code) {
  if (code == MXTT_BAD_ARGUMENT) return "unsupported shape or dtype";
  return cudaGetErrorString((cudaError_t)code);
}
