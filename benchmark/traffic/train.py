"""Training steps back to back (``make_train_step``: loss, gradients
through the linear-attention forward, the global-norm clip, Adam).

The mix file gives the ``pool`` of synthetic windows made on the card at
set-up (pose and face motion, mel, HuBERT-large features, a speaker, a
semantic score), the ``batch`` each step draws from it by index (all
rows different), the program's settings, and how many steps the traced
run traces (``trace_steps``).  The timesteps and the noise of each step
are drawn by the benchmark from the seed and handed to the step.
Set-up builds the training state once and drives it through its first
``check_steps`` steps, which the check's reference follows; the window
goes on with the same state.  ``train_windows_per_s`` is the windows of
every step completed in the window over its seconds (it ends at a step
boundary, the first one past ``--seconds``).
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from benchmark import program, weights
from benchmark.flops import model as flops
from benchmark.reference import train as ref_train
from benchmark.reference.denoiser import UniDiffuser as RefUniDiffuser


def make_pool(config, n, seed, device):
    m = config["model"]
    T = config["data"]["n_poses"]
    g = weights.generator(seed, "pool", device)
    style = torch.randint(m["style_dim"], (n,), generator=g, device=device)
    return {
        "motion": torch.randn((n, T, m["pose_dim"] + m["expression_dim"]),
                              generator=g, device=device),
        "mel": torch.randn((n, T, m["audio_dim"]), generator=g, device=device),
        "hubert": torch.randn((n, T, m["hubert_dim"]), generator=g,
                              device=device),
        "pid": torch.nn.functional.one_hot(style, m["style_dim"]).float(),
        "sem": torch.rand((n, T), generator=g, device=device),
    }


class Generator:
    def __init__(self, cell, mix, config, seed, device, tracer):
        self.cell, self.mix, self.seed = cell, mix, seed
        self.device, self.tracer = device, tracer
        self.config = program.merged(config, mix["program"])
        self.batch_size = mix["batch"]
        self.n_check = mix["check_steps"]

    def draw(self, k):
        """Step ``k``'s rows, timesteps and noise."""
        dev = self.device
        g = weights.generator(self.seed, f"step:{k}", dev)
        rows = torch.randperm(self.mix["pool"], generator=g,
                              device=dev)[:self.batch_size]
        t = torch.randint(self.config["diffusion"]["num_steps"],
                          (self.batch_size,), generator=g, device=dev)
        shape = (self.batch_size,) + self.pool["motion"].shape[1:]
        noise = torch.randn(shape, generator=g, device=dev)
        return {k_: v[rows] for k_, v in self.pool.items()}, t, noise

    # -- set-up ------------------------------------------------------------
    def setup(self):
        from diffsheg_tpu_torch.diffusion.schedule import (
            get_named_beta_schedule, make_schedule)
        from diffsheg_tpu_torch.train.step import (create_train_state,
                                                   make_train_step)
        program.precise(True)
        conf = self.config
        cfg = program.port_config(conf)
        dev = self.device
        self.pool = make_pool(conf, self.mix["pool"], self.seed, dev)
        model = program.port_denoiser(
            cfg, program.denoiser_state(conf, self.seed, dev), dev)
        self.state = create_train_state(cfg, model, dev)
        sched = make_schedule(get_named_beta_schedule(
            cfg.diffusion.beta_schedule, cfg.diffusion.num_steps))
        self.step = make_train_step(cfg, sched, inject_randoms=True)
        named = dict(self.state.model.named_parameters())
        start = {n: p.detach().clone() for n, p in named.items()}
        self.losses, self.k = [], 0
        for k in range(self.n_check):
            self._step()
            self.losses.append(float(self.terms.total))
            if k == 0:
                # the first gradient as Adam got it: exp_avg = (1 - b1) g
                opt = self.state.optimizer
                b1 = opt.param_groups[0]["betas"][0]
                self.first_grad = {
                    n: float(opt.state[p]["exp_avg"].norm() / (1 - b1))
                    for n, p in named.items()}
        self.change = {n: float((p.detach() - start[n]).norm())
                       for n, p in named.items()}
        del start
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def _step(self):
        batch, t, noise = self.draw(self.k)
        with self.tracer.span("step"):
            self.state, self.terms = self.step(self.state, batch, t, noise)
        self.k += 1

    # -- the window ----------------------------------------------------------
    def run(self, seconds):
        from diffsheg_tpu_torch.ops.linear_attention import \
            fused_linear_attention as la
        tracing = self.tracer.enabled
        n_trace = self.mix["trace_steps"]
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        steps = failed = 0
        view = trace_window = facts = None
        t0 = time.perf_counter()
        times, cpu = [], []
        while True:
            t_item, c_item = time.perf_counter(), time.process_time()
            if tracing and steps == 0:
                before = la.launches_by_shape.copy()
                self.tracer.start()
            self._step()
            loss = float(self.terms.total)      # waits for the step
            failed += not (loss == loss and abs(loss) != float("inf"))
            steps += 1
            times.append(time.perf_counter() - t_item)
            cpu.append(time.process_time() - c_item)
            if tracing and steps == n_trace:
                view = self.tracer.stop()
                lo, hi = view.window()
                trace_window = (view.busy(lo, hi), hi - lo)
                facts = self._facts(n_trace, la.launches_by_shape - before)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and (not tracing or steps >= n_trace):
                break
        if facts is not None and self.device.type == "cuda":
            facts["peak_bytes"] = torch.cuda.max_memory_allocated()
        return {"attempted": steps, "failed": failed, "item_seconds": times,
                "item_cpu_seconds": cpu,
                "end_to_end": {"train_windows_per_s":
                               steps * self.batch_size / elapsed},
                "trace": view, "trace_window": trace_window, "facts": facts}

    def _facts(self, steps, launches):
        m, T = self.config["model"], self.config["data"]["n_poses"]
        return {"config": self.config, "items": steps,
                "ops_per_item": 3 * flops.training_forward_ops(
                    m, self.batch_size, T),
                "linear_attention_launches": dict(launches)}

    def free(self):
        self.state = self.step = self.terms = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------------
    def reference(self, tf32=False):
        """(losses, first-gradient leaf norms, change leaf norms) of the
        reference over the first ``check_steps`` steps."""
        program.precise(not tf32)
        cfg, dev = self.config, self.device
        ref = weights.build(RefUniDiffuser, cfg["model"],
                            state=program.denoiser_state(cfg, self.seed, dev),
                            device=dev)
        names, params = zip(*ref.named_parameters())
        start = [p.detach().clone() for p in params]
        opt = ref_train.Adam(list(params), cfg["train"]["lr"])
        tab = ref_train.Tables(cfg["diffusion"]["num_steps"], dev)
        losses, first = [], None
        for k in range(self.n_check):
            batch, t, noise = self.draw(k)
            loss, grads = ref_train.train_step(
                ref, opt, tab, cfg["train"], batch, t, noise,
                remat=cfg["model"].get("remat", False))
            losses.append(loss)
            if k == 0:
                first = {n: float(g.norm()) for n, g in zip(names, grads)}
        change = {n: float((p.detach() - s).norm())
                  for n, p, s in zip(names, params, start)}
        program.precise(True)
        return losses, first, change

    def check(self):
        losses, first, change = self.reference()
        return compare(self.cell["limits"], self.losses, self.first_grad,
                       self.change, losses, first, change)


def leaf_gap(prog, ref, keep=None):
    """The worst leaf's |norm - reference norm|, against the larger of its
    reference norm and the median leaf's; leaves by name."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def compare(limits, losses, first, change, r_losses, r_first, r_change):
    """Each compared number beside its limit.  Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone under Adam and are left out of the change."""
    med = statistics.median(r_first.values())
    keep = {n for n, g in r_first.items() if g >= 1e-3 * med}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
    return {
        "loss_rel_gap": {"value": loss_gap, "limit": limits["loss_rel_gap"]},
        "first_grad_leaf_gap": {"value": leaf_gap(first, r_first),
                                "limit": limits["first_grad_leaf_gap"]},
        "change_leaf_gap": {"value": leaf_gap(change, r_change, keep),
                            "limit": limits["change_leaf_gap"]},
    }
