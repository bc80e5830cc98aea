"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (the counterparts of the reference's Pallas kernels):

- :mod:`~repro_torch.kernels.approx_add`  <- ``approx_add_pallas``
- :mod:`~repro_torch.kernels.accumulate`  <- ``accumulate_pallas``
- :mod:`~repro_torch.kernels.conv_chain`  <- ``filter_chain_pallas``
- :mod:`~repro_torch.kernels.lut_add`     <- ``lut_add_pallas``
- :mod:`~repro_torch.kernels.butterfly`   <- ``butterfly_pallas``
- :mod:`~repro_torch.kernels.mul`         <- ``mul_elementwise_pallas``
- :mod:`~repro_torch.kernels.mac_matmul`  <- ``mac_matmul_pallas``
- :mod:`~repro_torch.kernels.conv2d_mac`  <- ``conv2d_mac_pallas``
- :mod:`~repro_torch.kernels.approx_matmul` <- ``approx_matmul_pallas``

:mod:`~repro_torch.kernels.ops` keeps the reference's deprecated shims
(``approx_add``, ``approx_matmul``, ``butterfly``) over the engine.

Sources live in ``repro_torch/csrc``; :mod:`~repro_torch.kernels._build`
compiles them with ``nvcc`` for ``sm_90a`` on first use.  Nothing here
builds or imports a compiler when the module is imported.
"""
