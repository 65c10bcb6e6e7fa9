// Error text for the codes the kernel entry points return.
#include "common.cuh"

WCA_EXPORT const char* wca_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
