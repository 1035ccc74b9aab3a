"""lammps_ucg_dev_tpu_torch — the PyTorch/CUDA port of ``lammps_ucg_dev_tpu``.

The JAX package is the reference; this package mirrors its subpackages and
module names (``core/``, ``io/``, ``models/``, ``ops/``, ``fixes/``,
``runtime/``) so that each counterpart sits at the same path.  It imports
``torch`` and numpy and never ``jax``.

Layout idiom:
  * dataclasses of tensors in SoA layout with tag-stable rows;
  * plain functions on tensors, each taking its device from its inputs
    (constructors take an explicit ``device``);
  * one ``torch.Generator`` owned by ``runtime.sim.Simulation`` in place of
    the JAX ``SimState.key``;
  * the pair hot paths run hand-written Hopper kernels, built with ``nvcc``
    at their first launch: ``csrc/ucgld_pair.cu`` for ``table_ucgld``
    (``ops/hopper_pair.py``) and ``csrc/bethe_pair.cu`` for
    ``table_ucg_bethe`` (``ops/hopper_bethe.py``) and the density-CV styles,
    all on the shared span walk of ``csrc/colspan.cuh``, and
    ``csrc/ucgld_cluster.cu`` for ``table_ucgld`` on cluster lists
    (``ops/hopper_cluster.py``); on CPU tensors each wrapper runs its plain
    PyTorch twin.

Importing the package builds nothing and touches no GPU.
"""

__version__ = "0.1.0"
