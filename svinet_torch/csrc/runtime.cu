// Error reporting for the ctypes wrappers: every entry point returns a
// cudaError_t as an int, and the Python side turns it into a message.

#include <cuda_runtime.h>

extern "C" const char* svt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
