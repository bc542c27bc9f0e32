"""Runs the port's distributed cases on gloo ranks for the parity tests.

The test files of ``gpras_tpu_torch/parallel`` (tests/test_torch_parallel*.py,
test_torch_pcholesky2d.py, test_torch_hybrid.py, test_torch_psvgp.py) hold
the JAX package's functions on its 8 virtual devices against the port's on 8
CPU processes joined by gloo. This module imports no JAX: the processes are
started with the ``spawn`` method and import it, with
``tests/torch_dist_cases.py``, which holds the cases. Each file starts its
processes once (``Ranks``), while the parent computes the JAX side, and
reads every case's result from rank 0's pickle (``Ranks.results``).
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import pickle
import traceback
from pathlib import Path

WORLD = 8
#: seconds a collective may wait before gloo gives up (a case that raises on
#: one rank only leaves the others waiting)
COLLECTIVE_TIMEOUT = 120
#: seconds the parent waits for the processes
JOIN_TIMEOUT = 600


class Ranks:
    """``WORLD`` processes running one group of cases; ``results()`` waits
    for them and returns {case: [per-rank result]}."""

    def __init__(self, group: str, inputs: dict, tmp: Path, world: int = WORLD):
        self.out = tmp / "results.pkl"
        (tmp / "inputs.pkl").write_bytes(pickle.dumps(inputs))
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_child, args=(r, world, str(tmp), group))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self._results = None

    def results(self) -> dict:
        if self._results is None:
            for p in self.procs:
                p.join(JOIN_TIMEOUT)
            alive = [p for p in self.procs if p.is_alive()]
            for p in alive:
                p.kill()
                p.join()
            codes = [p.exitcode for p in self.procs]
            if alive or any(codes) or not self.out.exists():
                raise RuntimeError(f"gloo ranks failed: exit codes {codes}, "
                                   f"{len(alive)} killed at the time limit")
            self._results = pickle.loads(self.out.read_bytes())
        return self._results

    def case(self, name: str) -> list:
        """Every rank's result of case ``name``; raises with the first
        rank's traceback when the case raised."""
        per_rank = [r[name] for r in self.results()]
        for r in per_rank:
            if isinstance(r, CaseError):
                raise AssertionError(f"case {name} raised on a rank:\n{r.text}")
        return per_rank


class CaseError:
    def __init__(self, text: str):
        self.text = text


def _child(rank: int, world: int, tmp: str, group: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    cases = importlib.import_module("torch_dist_cases").GROUPS[group]
    inputs = pickle.loads((Path(tmp) / "inputs.pkl").read_bytes())
    results = {}
    for name, fn in cases.items():
        try:
            results[name] = fn(inputs)
        except Exception:  # recorded for the test that reads this case
            results[name] = CaseError(traceback.format_exc())
    gathered = [None] * world if rank == 0 else None
    dist.gather_object(results, gathered, dst=0)
    if rank == 0:
        (Path(tmp) / "results.pkl").write_bytes(pickle.dumps(gathered))
    dist.destroy_process_group()
