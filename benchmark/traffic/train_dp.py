"""Data-parallel training steps, one process a card, as the reference
trains (``mp.spawn`` with one process a GPU and DDP): ``train.py``'s
steps with the global batch shared out.

The benchmark's process is rank 0 on the first card; it starts ranks 1 to
``processes - 1`` (the cell's ``chips`` unless the mix says otherwise),
each a fresh interpreter that imports this file, on a card of its own.
All join the default process group (NCCL on the cards, gloo on the CPU)
at ``tcp://localhost:<a free port>``.  Every process makes the same pool,
weights, rows, timesteps and noise from the seed (``train.py``'s draws)
and steps on its contiguous share of the global batch through the port's
own data-parallel step (``make_train_step``: the flat f32 gradient
all-reduce, BatchNorm over the global batch); rank 0 tells the others,
before each step, whether there is one.

Nothing hangs: the group's start and every collective time out after
``join_timeout_s`` (the process group's timeout), each rank's leaving of
the group and each child's exit after it wait at most ``LEAVE_S``, a
thread of rank 0 ends the run as soon as a child exits before it was told
to, children end themselves when rank 0 is gone, and rank 0 kills its
children on any failure or exit.  All ranks leave the group together,
after rank 0's last word, as NCCL's teardown needs (rank 0 waiting for its
children to leave first held them in NCCL's teardown for good).

``correct`` is ``train.py``'s: the global loss, first gradient and change
against the single-process f32 reference over the whole global batch
(the mean of equal per-process means is the batch mean).
"""

from __future__ import annotations

import atexit
import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:            # a child starts from this file
    sys.path.insert(0, ROOT)

from benchmark.flops import model as flops  # noqa: E402
from benchmark.traffic import train  # noqa: E402

# the most seconds a rank may take to leave the group, and a child to exit
# after rank 0's last word (both take well under one when nothing is wrong)
LEAVE_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join_group(rank, world, port, device, timeout_s):
    """Join the default group; returns the group's store, which rank 0
    serves and keeps until its children have left."""
    import torch.distributed as dist
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore("localhost", port, world, rank == 0, timeout)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", store=store,
        world_size=world, rank=rank, timeout=timeout)
    return store


class Generator(train.Generator):
    def __init__(self, cell, mix, config, seed, device, tracer, rank=0,
                 port=None):
        super().__init__(cell, mix, config, seed, device, tracer)
        self.world = mix.get("processes") or cell["chips"]
        if self.batch_size % self.world:
            raise ValueError(f"batch {self.batch_size} does not split over "
                             f"{self.world} processes")
        self.local = self.batch_size // self.world
        self.rank, self.port = rank, port
        self.timeout_s = mix["join_timeout_s"]
        self.children = []
        self.stopped = False
        self.spec = {"cell": cell, "mix": mix, "config": config,
                     "seed": seed, "device": device.type}

    # -- processes -----------------------------------------------------------
    def _spawn(self):
        self.port = free_port()
        for r in range(1, self.world):
            spec = dict(self.spec, rank=r, port=self.port)
            self.children.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), json.dumps(spec)],
                cwd=ROOT))
        atexit.register(self.kill_children)
        threading.Thread(target=self._watch_children, daemon=True).start()

    def _watch_children(self):
        """End the run at once if a child exits before it was stopped."""
        while not self.stopped:
            for r, p in enumerate(self.children, 1):
                rc = p.poll()
                if rc is not None and not self.stopped:
                    print(f"train_dp: rank {r} exited with {rc}; ending the "
                          "run", file=sys.stderr, flush=True)
                    self.kill_children()
                    os._exit(1)
            time.sleep(0.2)

    def kill_children(self):
        for p in self.children:
            if p.poll() is None:
                p.kill()
        for p in self.children:
            try:
                p.wait(timeout=self.timeout_s)
            except subprocess.TimeoutExpired:
                pass

    def _go(self, more: bool) -> bool:
        """Rank 0 tells the others whether another step follows."""
        import torch.distributed as dist
        from diffsheg_tpu_torch.parallel.collectives import group_device
        flag = torch.tensor([int(more)], device=group_device())
        dist.broadcast(flag, 0)
        return bool(flag.item()) if self.rank else more

    # -- set-up ------------------------------------------------------------
    def setup(self):
        if self.rank == 0:
            if self.world > 1:
                self._spawn()
            else:
                self.port = free_port()
        try:
            self.store = join_group(self.rank, self.world, self.port,
                                    self.device, self.timeout_s)
            if self.mix.get("fail_rank") == self.rank:   # the harness's test
                raise RuntimeError(f"rank {self.rank} fails on purpose")
            super().setup()
        except BaseException:
            self.stopped = True
            self.kill_children()
            raise

    def _step(self):
        if self.world > 1:
            self._go(True)
        self._own_rows_step()

    def _own_rows_step(self):
        batch, t, noise = self.draw(self.k)
        lo = self.rank * self.local
        batch = {k: v[lo:lo + self.local] for k, v in batch.items()}
        with self.tracer.span("step"):
            self.state, self.terms = self.step(self.state, batch, t, noise)
        self.k += 1

    def serve_steps(self):
        """A child's steps: one each time rank 0 says so."""
        while self._go(False):
            self._own_rows_step()

    def _facts(self, steps, launches):
        facts = super()._facts(steps, launches)
        m, T = self.config["model"], self.config["data"]["n_poses"]
        facts.update(ops_per_item=3 * flops.training_forward_ops(
            m, self.local, T), ops_per_item_is="3 x the forward of one "
            "card's rows a step (rank 0's)", processes=self.world)
        return facts

    def leave_group(self):
        """Leave the process group, every rank at once: NCCL's teardown
        waits for the other ranks' (a rank that waited for its peers to
        exit first would wait for ever).  A teardown that outlasts the
        timeout ends the process."""
        import torch.distributed as dist

        def stuck():
            print(f"train_dp: rank {self.rank} could not leave the process "
                  "group", file=sys.stderr, flush=True)
            self.kill_children()
            os._exit(1)

        timer = threading.Timer(LEAVE_S, stuck)
        timer.daemon = True
        timer.start()
        dist.destroy_process_group()
        timer.cancel()

    def free(self):
        if self.rank == 0 and not self.stopped:
            self.stopped = True
            try:
                if self.world > 1:
                    self._go(False)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize()
                self.leave_group()
                for p in self.children:
                    p.wait(timeout=LEAVE_S)
                bad = [p.returncode for p in self.children if p.returncode]
                if bad:
                    raise RuntimeError(f"train_dp: a rank exited with {bad}")
            finally:
                self.kill_children()
                self.store = None
        super().free()


def child(spec):
    """Rank ``spec['rank']``: join, step in lockstep, leave."""
    from benchmark.harness import cache_dirs, forbidden_modules
    from benchmark.tracing import Tracer
    cache_dirs()
    torch.set_num_threads(1)
    parent = os.getppid()

    def watch_parent():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=watch_parent, daemon=True).start()
    rank = spec["rank"]
    device = (torch.device("cuda", rank) if spec["device"] == "cuda"
              else torch.device("cpu"))
    gen = Generator(spec["cell"], spec["mix"], spec["config"], spec["seed"],
                    device, Tracer(False, ""), rank=rank, port=spec["port"])
    gen.setup()
    gen.serve_steps()
    gen.leave_group()
    found = forbidden_modules()
    if found:
        print(f"train_dp: rank {rank} loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    code = child(json.loads(sys.argv[1]))
    # the work is done and said: end without the interpreter's teardown,
    # whose C++ destructors can abort once the group's other ranks are gone
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
