"""Multi-device / multi-host parallelism for the align engine.

The reference scales out at the shell level — GNU parallel over barcode
bucket files plus OpenMP threads inside one process (reference:
README.md:91-155, src/main.c:396-412).  Here the same three levels map to:

  - chips within a host:  a ``jax.sharding.Mesh`` with a ``data`` axis for
    read batches and a ``cand`` axis for per-read candidate windows
    (``ema_tpu.parallel.step``),
  - hosts within a pod:   barcode buckets hashed to hosts
    (``ema_tpu.parallel.distrib``), one JAX process per host,
  - collectives:          psum of global stats / preproc priors over the
    mesh instead of files-on-disk merging.
"""

from ema_tpu.parallel.mesh import make_mesh, mesh_axes  # noqa: F401
from ema_tpu.parallel.step import (  # noqa: F401
    candidate_core, make_sharded_candidate_step)
