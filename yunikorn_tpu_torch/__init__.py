"""yunikorn_tpu_torch: the batch scheduling framework on PyTorch and CUDA.

Capability-equivalent to apache/yunikorn-k8shim + in-process yunikorn-core,
with the per-pod scheduling loop reframed as a batched constraint solve on
an NVIDIA card (hand-written CUDA kernels under csrc/). Importing the
package loads nothing and starts no thread.
"""

__version__ = "0.1.0"
