"""Per-parameter-group Adam (counterpart of ``gstex_tpu/train/optim.py``).

| group         | param leaf      | lr                     | schedule |
|---------------|-----------------|------------------------|----------|
| xyz           | means           | spatial_scale · 1.6e-5 | exp → /10 over max_steps |
| features_dc   | features_dc     | 2.5e-3                 | — |
| features_rest | features_rest   | 1.25e-4                | — |
| opacity       | opacity_logits  | 0.05                   | — |
| scaling       | log_scales      | 5e-3                   | — |
| rotation      | quats           | 1e-3                   | — |
| texture_dc    | texture         | 1e-3                   | — |

Adam (``Adam`` below) with betas 0.9/0.999 and eps 1e-15, one param
group per row. The xyz learning rate is set before each update from the
group's count of updates already made, as optax evaluates a schedule.
``OptimConfig.gradient_accumulation`` makes a group accumulate k steps an
update, as ``optax.MultiSteps`` does. The ``camera_opt`` group's own
optimizer (``make_pose_optimizer``: Adam 1e-3 → 5e-5 over 30000
updates, 100 steps an update) steps the pose deltas, which are per
dataset, not model params.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models.gstex import GStexParams


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Per-group optimizer settings (see module docstring)."""

    spatial_scale: float = 5.0
    xyz_lr_mult: float = 1.0
    max_steps: int = 15000
    features_dc_lr: float = 2.5e-3
    features_rest_lr: float = 2.5e-3 / 20
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    texture_lr: float = 1e-3
    adam_eps: float = 1e-15
    # per-group gradient accumulation, e.g. (("texture_dc", 4),)
    gradient_accumulation: tuple = ()


GROUP_OF_LEAF = GStexParams(
    means="xyz",
    log_scales="scaling",
    quats="rotation",
    opacity_logits="opacity",
    features_dc="features_dc",
    features_rest="features_rest",
    texture="texture_dc",
)


def exp_decay_schedule(lr_init: float, lr_final: float, max_steps: int,
                       warmup_steps: int = 0, ramp: str = "cosine"):
    """step -> lr: log-space interpolation from lr_init to lr_final over
    max_steps, after an optional warmup."""

    def fn(step):
        t = min(max((step - warmup_steps) / (max_steps - warmup_steps), 0.0),
                1.0)
        lr = math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
        if step < warmup_steps:
            frac = min(max(step / warmup_steps, 0.0), 1.0)
            lr = lr_init * (math.sin(0.5 * math.pi * frac)
                            if ramp == "cosine" else frac)
        return lr

    return fn


def group_lrs(cfg: OptimConfig) -> dict:
    """Group name -> constant lr, or a step -> lr schedule for xyz."""
    return {
        "xyz": exp_decay_schedule(cfg.spatial_scale * 1.6e-5 * cfg.xyz_lr_mult,
                                  cfg.spatial_scale * 1.6e-6, cfg.max_steps),
        "features_dc": cfg.features_dc_lr,
        "features_rest": cfg.features_rest_lr,
        "opacity": cfg.opacity_lr,
        "scaling": cfg.scaling_lr,
        "rotation": cfg.rotation_lr,
        "texture_dc": cfg.texture_lr,
    }


def _lr_at(lr, count: int) -> float:
    return lr(count) if callable(lr) else lr


def _bias_correction(beta: float, count: int) -> float:
    """1 − β^t in float32, as optax forms it (``scale_by_adam``)."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(count))


class Adam(torch.optim.Optimizer):
    """Adam (betas 0.9/0.999) over named param groups, as
    ``optax.multi_transform`` of ``optax.adam`` runs them.

    A group's lr is a constant or a schedule of the group's count of
    updates already made, read before each update. The bias corrections
    1 − β^t are float32, as optax's are; the rest is ``torch.optim.Adam``'s
    foreach arithmetic, one call for every param that updates.

    A group named in ``every`` with k > 1 accumulates as ``optax.MultiSteps``
    does: its gradient joins a running mean ``acc + (g − acc) / (m + 1)``
    (``m`` the state's ``mini_step``); only when ``m == k − 1`` does the
    mean update the param (and the count, and so the schedule), and the
    mean is zeroed; on the other steps the param is left as it is. Such
    params hold their whole state from the start: ``step``, ``exp_avg``,
    ``exp_avg_sq``, ``acc`` and the host ints ``mini_step`` and
    ``gradient_step``, so that a step needs no host sync."""

    def __init__(self, groups, lrs: dict, every: dict | None = None,
                 eps: float = 1e-15):
        self.lrs = dict(lrs)
        self.every = {k: int(v) for k, v in dict(every or {}).items()
                      if int(v) > 1}
        super().__init__(
            [{"params": list(ps), "name": name, "lr": _lr_at(lrs[name], 0)}
             for name, ps in groups], dict(betas=(0.9, 0.999), eps=eps))
        # the params the last ``step`` with a table updated
        self._table_updated: set = set()
        for group in self.param_groups:
            if group["name"] in self.every:
                for p in group["params"]:
                    self.state[p] = dict(self._fresh(p),
                                         acc=torch.zeros_like(p),
                                         mini_step=0, gradient_step=0)

    @staticmethod
    def _fresh(p) -> dict:
        return {"step": torch.tensor(0.0),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}

    def _accumulate(self, st: dict, grad, k: int):
        """The MultiSteps mean; the gradient to update with (the mean,
        zeroed after the update), or ``None``."""
        m, acc = st["mini_step"], st["acc"]
        acc.add_((grad - acc) / (m + 1))
        st["mini_step"] = (m + 1) % k
        if m != k - 1:
            return None
        st["gradient_step"] += 1
        return acc

    def step_table(self, n: int, device) -> torch.Tensor:
        """The per-step values of the next ``n`` steps, for ``step`` with
        a ``table``: (n, groups, 4) float32 rows of √(1 − β₂^t) and
        −lr / (1 − β₁^t), the numbers the host path passes as Python
        floats, from each group's count and schedule at the update's
        count t; then, for an accumulating group, the running mean's
        divisor m + 1 (``mini_step`` m) and 1 where the step ends the
        group's k and updates (1 and 1 for the other groups). A step that
        only accumulates holds the values of the group's next update."""
        b1, b2 = self.defaults["betas"]
        rows = np.ones((n, len(self.param_groups), 4), np.float32)
        for g, group in enumerate(self.param_groups):
            k, m = self._cycle(group)
            t = self._count(group)
            for i in range(n):
                rows[i, g, 0] = math.sqrt(_bias_correction(b2, t + 1))
                rows[i, g, 1] = (-_lr_at(self.lrs[group["name"]], t)
                                 / _bias_correction(b1, t + 1))
                rows[i, g, 2] = (m + i) % k + 1
                rows[i, g, 3] = apply = (m + i) % k == k - 1
                t += apply
        return torch.from_numpy(rows).to(device)

    def _cycle(self, group) -> tuple[int, int]:
        """The group's k and ``mini_step`` (1 and 0 where it updates every
        step)."""
        k = self.every.get(group["name"], 1)
        return k, self._common(group, "mini_step") if k > 1 else 0

    def _common(self, group, key: str) -> int:
        """A host count of the group's params' state, common to them."""
        counts = {int(self.state[p][key]) if self.state.get(p) else 0
                  for p in group["params"]}
        if len(counts) != 1:
            raise ValueError(f"group {group['name']!r}: its params' {key} "
                             f"differ {counts}")
        return counts.pop()

    def _count(self, group) -> int:
        """The updates a group has made (its params' common count)."""
        return self._common(group, "step")

    def advance(self, n: int) -> None:
        """Count ``n`` steps made by ``step`` with a table (which leaves
        the host's counts alone) for the params it updated: their
        updates, and an accumulating group's ``mini_step`` and
        ``gradient_step``; and set their groups' lr as the host path's
        last update would have."""
        for group in self.param_groups:
            ps = [p for p in group["params"] if p in self._table_updated]
            if not ps:
                continue
            k, m = self._cycle(group)
            # the steps whose mini_step is k - 1
            updates = (m + n) // k - m // k
            if updates:
                group["lr"] = _lr_at(self.lrs[group["name"]],
                                     self._count(group) + updates - 1)
            for p in ps:
                st = self.state[p]
                st["step"] += updates
                if k > 1:
                    st["mini_step"] = (st["mini_step"] + n) % k
                    st["gradient_step"] += updates

    @torch.no_grad()
    def step(self, closure=None, table=None, pos=None):
        """One update. With ``table`` (``step_table``'s rows on the params'
        device) and ``pos`` ((1,) int64 on that device), the update reads
        its per-step values from row ``pos`` on the device and makes no
        host read or write: a CUDA graph can hold it and replay it with
        ``pos`` advanced. Every param must then have a gradient, and the
        counts move by ``advance`` once the graph's updates are made."""
        if table is not None:
            return self._table_step(table, pos)
        b1, b2 = self.defaults["betas"]
        params, grads, mus, nus, denom_div, step_size = [], [], [], [], [], []
        accs = []
        for group in self.param_groups:
            k = self.every.get(group["name"], 1)
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(self._fresh(p))
                grad = p.grad
                if k > 1:
                    grad = self._accumulate(st, grad, k)
                    if grad is None:
                        continue
                    accs.append(grad)
                count = int(st["step"])
                group["lr"] = _lr_at(self.lrs[group["name"]], count)
                st["step"] += 1
                params.append(p)
                grads.append(grad)
                mus.append(st["exp_avg"])
                nus.append(st["exp_avg_sq"])
                denom_div.append(math.sqrt(_bias_correction(b2, count + 1)))
                step_size.append(-group["lr"]
                                 / _bias_correction(b1, count + 1))
        if not params:
            return None
        torch._foreach_lerp_(mus, grads, 1 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, 1 - b2)
        denom = torch._foreach_sqrt(nus)
        torch._foreach_div_(denom, denom_div)
        torch._foreach_add_(denom, self.defaults["eps"])
        torch._foreach_addcdiv_(params, mus, denom, step_size)
        for acc in accs:
            acc.zero_()
        return None


    def _table_step(self, table, pos):
        """``step`` from row ``pos`` of ``table``: the same operations as
        the host path, in the same order, with the per-group values as
        0-d device tensors. The update ``p + v · m / d`` is written out
        as the CPU's ``addcdiv_`` rounds it, so that on the CPU both paths
        give the same bits; on the card ``addcdiv_`` may round ``v · (m /
        d)`` instead, an ulp apart.

        An accumulating param adds its gradient to the running mean
        (``acc + (g − acc) / (m + 1)``, the divisor from the table), and
        every step computes the mean's update out of place, the same
        arithmetic, which ``torch.where`` writes over the param and its
        moments where the row's flag says the step ends the group's k;
        the mean is zeroed there. So every step runs the same operations,
        and nothing on the host reads the flag."""
        b1, b2 = self.defaults["betas"]
        row = table.index_select(0, pos)[0]           # (groups, 4)
        params, grads, mus, nus, dds, sss = [], [], [], [], [], []
        accs = []
        for g, group in enumerate(self.param_groups):
            for p in group["params"]:
                if p.grad is None:
                    # as the host path does; which params have none is
                    # the graph's structure, the same at every replay
                    continue
                st = self.state[p]
                if not st:
                    st.update(self._fresh(p))
                if group["name"] in self.every:
                    st["acc"].add_((p.grad - st["acc"]) / row[g, 2])
                    accs.append((p, st, row[g, 0], row[g, 1], row[g, 3] != 0))
                    continue
                params.append(p)
                grads.append(p.grad)
                mus.append(st["exp_avg"])
                nus.append(st["exp_avg_sq"])
                dds.append(row[g, 0])
                sss.append(row[g, 1])
        self._table_updated = set(params) | {a[0] for a in accs}
        if params:
            torch._foreach_lerp_(mus, grads, 1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, 1 - b2)
            denom = torch._foreach_sqrt(nus)
            for d, dd in zip(denom, dds):
                d.div_(dd)
            torch._foreach_add_(denom, self.defaults["eps"])
            for p, m, d, ss in zip(params, mus, denom, sss):
                p.add_(ss * m / d)
        if accs:
            ps, sts, dds, sss, ons = zip(*accs)
            means = [st["acc"] for st in sts]
            mus = torch._foreach_lerp([st["exp_avg"] for st in sts], means,
                                      1 - b1)
            nus = torch._foreach_mul([st["exp_avg_sq"] for st in sts], b2)
            torch._foreach_addcmul_(nus, means, means, 1 - b2)
            denom = torch._foreach_sqrt(nus)
            for d, dd in zip(denom, dds):
                d.div_(dd)
            torch._foreach_add_(denom, self.defaults["eps"])
            for p, st, m, v, d, ss, on in zip(ps, sts, mus, nus, denom, sss,
                                              ons):
                torch.where(on, p + ss * m / d, p, out=p)
                torch.where(on, m, st["exp_avg"], out=st["exp_avg"])
                torch.where(on, v, st["exp_avg_sq"], out=st["exp_avg_sq"])
                st["acc"].masked_fill_(on, 0.0)
        return None


def make_optimizer(cfg: OptimConfig, params: GStexParams) -> Adam:
    """Adam over the seven leaves, one param group each (named by its
    ``GROUP_OF_LEAF`` group); the groups of ``cfg.gradient_accumulation``
    accumulate as ``optax.MultiSteps`` does."""
    groups = [(name, [leaf]) for leaf, name in zip(params, GROUP_OF_LEAF)]
    return Adam(groups, group_lrs(cfg), every=cfg.gradient_accumulation,
                eps=cfg.adam_eps)


def make_pose_optimizer(delta: torch.Tensor) -> Adam:
    """The ``camera_opt`` group: Adam(eps 1e-15) at an lr decaying
    exponentially from 1e-3 to 5e-5 over 30000 updates, accumulating 100
    steps an update."""
    return Adam([("camera_opt", [delta])],
                {"camera_opt": exp_decay_schedule(1e-3, 5e-5, 30000)},
                every={"camera_opt": 100})


def reset_texture_moments(opt: Adam) -> None:
    """Zero the texture group's Adam moments after a re-chart (its count,
    and an accumulating group's mean and ``mini_step``, stay), as the
    reference's ``reshape_in_optim`` does."""
    for group in opt.param_groups:
        if group["name"] != "texture_dc":
            continue
        for p in group["params"]:
            state = opt.state.get(p)
            if state:
                state["exp_avg"].zero_()
                state["exp_avg_sq"].zero_()
