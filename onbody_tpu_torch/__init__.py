"""onbody_tpu_torch — the onbody fast-summation engine in PyTorch and CUDA.

A second package beside `onbody_tpu` (the JAX reference). It mirrors the
reference module for module (`ops/`, `tree/`, `traverse/`, `parallel/`,
`api/`) and keeps its
array layouts at every public function, so each stage can be held
against its reference counterpart on the same inputs.

Plain tensor work (sorts, gathers, scans, the barycentric einsums) is
ordinary torch code on whatever device the tensors live on. The kernels
the reference wrote in Pallas are hand-written CUDA C++ for Hopper
(`ops/csrc/`), built with nvcc at first use and bound with ctypes. Each
has a plain PyTorch twin in the same module; a wrapper takes the twin
only for tensors on the CPU.

This package never imports jax.
"""

from onbody_tpu_torch.config import SolverConfig, tuned_config
from onbody_tpu_torch.parts import Parts

__version__ = "0.1.0"
