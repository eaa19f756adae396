"""Learning-rate schedules (port of ``mhrec_tpu/trainer/lr_schedule.py``):
constant / linear / cosine (+hard restarts) / polynomial decay with warmup,
plus warmup multi-step. Warmup is a fraction of ``total_iters``.

Each schedule is a plain function of the integer step that returns a Python
float. The arithmetic is optax's (``polynomial_schedule``,
``join_schedules``, ``piecewise_constant_schedule``) done in numpy float32,
so a learning rate carries the same float32 rounding as the JAX package's.
As there, the second piece of a joined schedule receives the step counted
from its boundary — the cosine pieces then subtract the warmup once more,
which this port keeps for parity.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

f32 = np.float32
Schedule = Callable[[int], float]


def _polynomial(init: float, end: float, power, steps: int, begin: int = 0) -> Schedule:
    if steps <= 0:
        return lambda count: float(f32(init))

    def schedule(count):
        c = min(max(int(count) - begin, 0), steps)
        frac = f32(1) - f32(c) / f32(steps)
        return float(f32(init - end) * frac ** f32(power) + f32(end))

    return schedule


def _linear(init: float, end: float, steps: int) -> Schedule:
    return _polynomial(init, end, 1, steps)


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    def schedule(step):
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def _piecewise_constant(init: float, boundaries_and_scales) -> Schedule:
    def schedule(count):
        v = f32(init)
        for threshold, scale in sorted(boundaries_and_scales.items()):
            indicator = f32(max(0.0, float(np.sign(threshold - int(count)))))
            v = v * indicator + (f32(1) - indicator) * f32(scale) * v
        return float(v)

    return schedule


def build_schedule(scheduler_args, base_lr: float, total_iters: int) -> Schedule:
    args = dict(scheduler_args or {})
    kind = args.get("type", "constant")
    warmup_frac = float(args.get("warmup", 0.0))
    warmup_steps = int(warmup_frac * total_iters)

    if kind == "constant":
        const = lambda step: float(f32(base_lr))  # noqa: E731
        if warmup_steps > 0:
            return _join([_linear(0.0, base_lr, warmup_steps), const], [warmup_steps])
        return const

    if kind == "linear":
        return _join(
            [_linear(0.0, base_lr, max(warmup_steps, 1)),
             _linear(base_lr, 0.0, max(total_iters - warmup_steps, 1))],
            [warmup_steps],
        )

    if kind == "cosine":
        cycles = float(args.get("num_cycles", 0.5))

        def cosine(step):
            decay_steps = max(total_iters - warmup_steps, 1)
            progress = f32(int(step) - warmup_steps) / f32(decay_steps)
            progress = min(max(progress, f32(0)), f32(1))
            c = f32(0.5) * (f32(1) + np.cos(f32(math.pi * 2.0 * cycles) * progress))
            return float(f32(base_lr) * max(f32(0), c))

        return _join([_linear(0.0, base_lr, max(warmup_steps, 1)), cosine], [warmup_steps])

    if kind == "cosine_with_restarts":
        cycles = int(args.get("num_cycles", 1))

        def cos_restart(step):
            decay_steps = max(total_iters - warmup_steps, 1)
            progress = f32(int(step) - warmup_steps) / f32(decay_steps)
            progress = min(max(progress, f32(0)), f32(1.0 - 1e-9))
            within = np.mod(progress * f32(cycles), f32(1))
            c = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * within))
            return float(f32(base_lr) * max(f32(0), c))

        return _join([_linear(0.0, base_lr, max(warmup_steps, 1)), cos_restart],
                     [warmup_steps])

    if kind == "polynomial":
        power = float(args.get("power", 1.0))
        end_lr = float(args.get("lr_end", 1e-7))
        return _join(
            [_linear(0.0, base_lr, max(warmup_steps, 1)),
             _polynomial(base_lr, end_lr, power, max(total_iters - warmup_steps, 1))],
            [warmup_steps],
        )

    if kind == "multistep":
        milestones = list(args.get("milestones", []))
        gamma = float(args.get("gamma", 0.1))
        sched = _piecewise_constant(base_lr, {m: gamma for m in milestones})
        if warmup_steps > 0:
            return _join([_linear(0.0, base_lr, warmup_steps), sched], [warmup_steps])
        return sched

    raise ValueError(f"Unknown scheduler type: {kind}")
