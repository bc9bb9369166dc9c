"""sharkmer_tpu_torch — the PyTorch/CUDA port of sharkmer_tpu.

The same canonical k-mer counting, chunked spectra and in silico PCR
as the JAX package ``sharkmer_tpu``, with the same CLI and the same
output files, on one NVIDIA GPU (Hopper, ``sm_90a``). Module layout and
names follow the JAX package so that each counterpart is easy to find:

* ``ops/`` — canonical k-mer encoding, the int64 key codec, the sorted
  count store and the primer scans, as plain PyTorch tensor code;
* ``kernels/`` + ``csrc/`` — the hand-written CUDA kernels that replace
  the JAX package's Pallas kernels, each beside its plain PyTorch
  version (the CPU path and the test oracle);
* ``engine.py``, ``main.py`` — the counting engine and the CLI pipeline;
* ``cli.py``, ``stats.py``, ``format.py``, ``io/``, ``pcr/``,
  ``utils/``, ``panels/`` — host layers copied from the JAX package
  (it imports jax at package import, so they cannot be imported from
  there); a drift test keeps each copy's code equal to its original.

The device comes from ``SHARKMER_TORCH_DEVICE`` (``device.py``).
"""

__version__ = "0.1.0"
