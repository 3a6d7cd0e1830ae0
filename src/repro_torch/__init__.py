"""PyTorch/CUDA port of FLAME: the serving path and the federated round.

A second package beside :mod:`repro` (the JAX/Pallas reference).  Its
layout mirrors ``repro/`` so each module's counterpart is easy to find:
``configs``, ``kernels`` (plain PyTorch versions, hand-written CUDA kernels
for Hopper and the device dispatch between them), ``models``, ``serving``,
``core``, ``federated``, ``checkpoint``, ``obs``, ``launch`` and
``examples``.  The package imports ``torch``, numpy and the standard
library only — never ``jax`` and nothing of ``repro``.

Device rule: every entry point takes an explicit ``device`` (default
``"cuda"``).  A CUDA tensor runs the CUDA kernels; a CPU tensor runs their
plain PyTorch versions.  Nothing falls back from one to the other.
"""
