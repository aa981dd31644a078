"""Attic: counterparts of ``runet_tpu/kernels/attic``, the JAX package's
superseded Pallas kernels. As there, NO model config routes the model
through them; the kernel bench (``utils/kernel_bench.py``) runs them beside
the production kernels and the library calls, and each is held against its
plain version on the card (``chip_smoke.py``).

- ``conv3d.py`` replaces ``attic/conv3d.py::_conv_kernel`` (the per-conv
  im2col conv on NDHWC, no moments) with ``csrc/conv3x3_ndhwc.cu``, and its
  custom_vjp ``pallas_conv3x3`` with the autograd Function ``AtticConv``.
- ``conv_v3_deep.py`` replaces ``attic/conv_v3_deep.py::_v3_kernel`` (the
  deep-level NDHWC conv with Σy, Σy²) with ``csrc/conv3x3_ndhwc_stats.cu``:
  the k-steps of ``conv3x3_ndhwc.cu`` in the same order (so the same y),
  staged by ``cp.async`` where that kernel stages by TMA, with the moment
  epilogue.
- ``fused_norm.py`` replaces ``attic/fused_norm.py::_stats_kernel`` and
  ``::_apply_kernel`` (the two passes of the standalone InstanceNorm +
  LeakyReLU) with ``csrc/instance_norm_stats.cu`` and
  ``csrc/instance_norm_lrelu_apply.cu``.
"""
