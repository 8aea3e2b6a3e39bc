"""Learning-rate schedulers: ``num_update -> lr``.

The port's own copy of the reference's ``lr_scheduler.py`` (jax-free
there too, but importing it would run the reference package's
``__init__``, which imports jax). An optimizer given ``lr_scheduler=``
sets the scheduler's ``base_lr`` to its ``learning_rate`` and reads the
scheduler at its update count; ``FactorScheduler`` and
``MultiFactorScheduler`` keep state (the last boundary passed), so the
same sequence of reads gives the same rates in both packages.
"""
from __future__ import annotations

import logging

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler"]


class LRScheduler(object):
    """Base: maps num_update to a learning rate."""

    def __init__(self, base_lr: float = 0.01):
        self.base_lr = base_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates, down to ``stop_factor_lr``."""

    def __init__(self, step: int, factor: float = 1.0,
                 stop_factor_lr: float = 1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update: int) -> float:
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info("Update[%d]: now learning rate arrived at %0.5e, "
                             "will not change in the future", num_update,
                             self.base_lr)
            else:
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each of the increasing steps in ``step``."""

    def __init__(self, step, factor: float = 1.0):
        super().__init__()
        if len(step) < 1:
            raise ValueError("Schedule step must have at least one entry")
        for i, _step in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise ValueError("Schedule step must be an increasing list")
            if _step < 1:
                raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = list(step)
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update: int) -> float:
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay to zero over ``max_update`` updates."""

    def __init__(self, max_update: int, power: float = 2.0):
        super().__init__()
        self.max_update = max_update
        self.power = power

    def __call__(self, num_update: int) -> float:
        frac = min(float(num_update) / self.max_update, 1.0)
        return self.base_lr * ((1.0 - frac) ** self.power)
