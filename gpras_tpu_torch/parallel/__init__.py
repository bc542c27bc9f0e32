"""The distributed layer: sharded Gram builds, the distributed Cholesky and
its solves, the distributed exact-GP losses (dense, Hutchinson, CG), sharded
prediction, PCA, SVGP steps and hyperparameter searches, and the hybrid
("dp", "i", "j") step.

Port of ``gpras_tpu/parallel/`` onto ``torch.distributed``. One SPMD program
runs on every rank, as under ``torchrun``: NCCL between cards, gloo between
CPU processes. A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
the reference's axis names. Where the reference shards an argument
(``P("i")``, ``P("i", "j")``), the port's function takes this rank's shard;
where it replicates one (``P()``), the whole tensor on every rank. Each
function's docstring says which is which.
"""

from gpras_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
