"""Parallelism on ``torch.distributed``: the mesh, the halo exchange and the
spatially sharded RHS.

The JAX package parallelizes inside one process over many devices
(``shard_map``, ``ppermute``, GSPMD). The port runs one process per device,
as PyTorch does: a process group, a ``DeviceMesh`` with the axes

  * ``"data"``: the trajectory / sample batch (pure data parallelism, the
    primary axis);
  * ``"space"``: the periodic grid, split into contiguous blocks whose
    stencil and tower halos come from the ring neighbours by point-to-point
    sends.

  mesh.py     initialize_multihost (torchrun's environment, or a store of
              its own at world size 1), make_mesh
  halo.py     halo_exchange (differentiable), apply_stencil_local
  sharded.py  sharded_baseline_rhs, sharded_model_rhs

What GSPMD does for the JAX package is written out where it is needed: the
per-rank kernel launches (``StencilModel.fused_rk4_fn(mesh=)``), the batch
split, the gradient all-reduce and the grid-wide reductions of the loss
(``training/loop.train(mesh=)``, ``training/losses``), and the gather of an
ensemble's final state (``scripts/run_ensemble --data_parallel``).
"""

from pde_superresolution_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    SPACE_AXIS,
    initialize_multihost,
    make_mesh,
)
from pde_superresolution_torch.parallel.halo import (  # noqa: F401
    apply_stencil_local,
    halo_exchange,
)
from pde_superresolution_torch.parallel.sharded import (  # noqa: F401
    sharded_baseline_rhs,
    sharded_model_rhs,
)
