// The message for a cudaError_t that a kernel entry point returned.
#include <cuda_runtime.h>

extern "C" const char* segclip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
