"""gnnflow_tpu_torch — the PyTorch + CUDA port of ``gnnflow_tpu``.

Structure and names follow ``gnnflow_tpu/`` module for module; each port
module's docstring names its JAX counterpart.  The package imports
``torch`` and ``numpy`` only.  Its hot-path kernels are CUDA C++ written
for Hopper (``csrc/``), built with ``nvcc`` at first use and bound with
``ctypes`` (:mod:`gnnflow_tpu_torch.ops._build`); every kernel wrapper
runs its plain PyTorch version when handed CPU tensors.

Entry points (:class:`~gnnflow_tpu_torch.train.Trainer`,
:meth:`~gnnflow_tpu_torch.dynamic_graph.DynamicGraph.device_graph`,
:class:`~gnnflow_tpu_torch.models.dgnn.DGNN`) default to
``device="cuda"`` and raise when CUDA is asked for and missing.
"""
