"""The port's entry points: the six examples of ``examples/`` in the
repo root, each a module that ``python -m repro_torch.examples.<name>``
runs on the card (``--device cuda``, ``backend="cuda"``: the kernels) or,
with ``--device cpu``, on the CPU (``backend="torch"``: their plain
versions).  ``--backend torch`` on the card runs the plain versions
there.  Each module's ``main(argv=None)`` prints what the reference's
script prints and returns its figures as a dict.

- :mod:`~repro_torch.examples.quickstart`: the adder, Table-1 metrics,
  hardware cost, a batch of full adds and a residual add;
- :mod:`~repro_torch.examples.adder_design_space`: the exact (m, k)
  sweep and its Pareto frontier;
- :mod:`~repro_torch.examples.image_reconstruction`: Fig 5, FFT -> IFFT
  through each Table-1 adder (``fft_axis``);
- :mod:`~repro_torch.examples.approx_mac`: two conv layers, each on its
  own MAC engine (``conv2d_mac``);
- :mod:`~repro_torch.examples.serve_decode`: batched prefill and decode
  with the adder in the residual stream (``approx_add``);
- :mod:`~repro_torch.examples.train_approx_lm`: a ~60M-parameter LM
  trained with and without the adder (``approx_add``).
"""
