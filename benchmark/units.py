"""The units a window repeats: the program's entry points under test.

``sweep``: ``pairsnp_stream`` over an alignment whose layout is already on
the device, every block's survivors on the host (the unit of the port's
``experiments/bench.py``).  ``job``: the ``distance`` stage's streaming
driver on a fresh ``PackedAlignment`` of the configuration's planes, so each
job compacts, lays out, uploads, sweeps, runs the model, formats and writes
its CSV, as a ``distance --pack-cache`` run does once its planes are loaded.
"""

from __future__ import annotations

import argparse
import gc
import os

import numpy as np
import torch

from benchmark import generate


def _names(n: int) -> list:
    return [str(i) for i in range(n)]


class Sweep:
    """All-pairs sweeps of one resident alignment."""

    kind, e2e = "sweep", "sweep_pairs_per_s"

    def __init__(self, cfg: dict, traffic: dict, planes: np.ndarray, seed: int,
                 device: torch.device, workdir: str):
        from tracs_tpu_torch.ops.packing import PackedAlignment

        self.cfg, self.traffic, self.device = cfg, traffic, device
        n = cfg["samples"]
        self.pairs = n * (n - 1) // 2
        self.packed = PackedAlignment(planes=planes, length=cfg["sites"], names=_names(n))

    def warm(self) -> None:
        for _ in range(self.traffic["warmups"]):
            self.run(0)
        self.resident = self._resident()

    def _resident(self):
        split = getattr(self.packed, "_split_cache", None)
        return getattr(split, "_dev_cache", None)

    def run(self, index: int):
        """One sweep: (rows, cols, d, nn) numpy arrays of its survivors."""
        from tracs_tpu_torch.ops.pairsnp import pairsnp_stream

        blocks = [(rows, cols, d, nn) for _r0, _r1, _names, rows, cols, d, _f, nn
                  in pairsnp_stream([self.packed], dist=self.cfg["snp_threshold"],
                                    compact=self.traffic["compact"],
                                    row_block=self.cfg["row_block"],
                                    method=self.traffic["method"], device=self.device)]
        return tuple(np.concatenate([b[k] for b in blocks]) for k in range(4))

    def discard(self, output) -> None:
        pass

    def finish(self) -> None:
        if self._resident() is not self.resident:
            raise RuntimeError("the device layout was rebuilt inside the window")

    def metrics(self, elapsed: float, count: int) -> dict:
        return {self.e2e: (self.pairs * count / elapsed, "pairs/s")}

    def close(self) -> None:
        del self.packed


class Job:
    """Whole ``distance`` runs, each writing its own CSV under ``workdir``."""

    kind, e2e = "job", "job_s"

    def __init__(self, cfg: dict, traffic: dict, planes: np.ndarray, seed: int,
                 device: torch.device, workdir: str):
        from tracs_tpu_torch.stages import distance

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.planes, self.workdir = planes, workdir
        self.names = _names(cfg["samples"])
        argv = ["--msa", os.path.join(workdir, cfg["name"] + ".aln"),
                "-o", os.path.join(workdir, "job.csv"),
                "-D", str(cfg["snp_threshold"]), "--row-block", str(cfg["row_block"]),
                "--device", device.type]
        self.dates = None
        if traffic["meta"]:
            dates = os.path.join(workdir, "dates.csv")
            generate.write_dates(dates, cfg["samples"], cfg["cluster_size"], seed)
            argv += ["--meta", dates, "--clock_rate", repr(cfg["clock_rate"]),
                     "--trans_rate", repr(cfg["trans_rate"]), "--precision", repr(cfg["precision"])]
            self.dates = distance._load_dates(dates)
        if traffic["filter"]:
            argv.append("--filter")
        self.args = distance.distance_parser(argparse.ArgumentParser()).parse_args(argv)

    def warm(self) -> None:
        os.remove(self.run(-1))

    def run(self, index: int) -> str:
        """One job; returns the path of its CSV."""
        from tracs_tpu_torch.ops import recomb
        from tracs_tpu_torch.ops.packing import PackedAlignment
        from tracs_tpu_torch.stages import distance

        # a distance run starts in a fresh process: no keep tables of the
        # recombination filter from an earlier run
        recomb._keep_tables.clear()
        path = os.path.join(self.workdir, f"job{index}.csv")
        with open(path, "w") as fh:
            fh.write(distance.HEADER)
        self.args.output_file = path
        packed = PackedAlignment(planes=self.planes, length=self.cfg["sites"], names=self.names)
        distance._distance_streaming(self.args, self.device, self.dates, first_msa=0,
                                     first_packed=packed)
        # the job's layouts hold each other in cycles: free them as the end
        # of a distance process would, before the next job allocates
        del packed
        gc.collect()
        return path

    def discard(self, path: str) -> None:
        os.remove(path)

    def finish(self) -> None:
        pass

    def metrics(self, elapsed: float, count: int) -> dict:
        return {self.e2e: (elapsed / count, "s")}

    def close(self) -> None:
        pass


UNITS = {"sweep": Sweep, "job": Job}
