"""Learning-rate schedulers: the counterpart of ``mxnet_tpu/lr_scheduler.py``.

A scheduler maps the optimizer's update count to a learning rate.  The
trainer calls it on the host once per step (``optimizer.lr_scheduler``).
"""
from __future__ import annotations

import logging

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates, floored at ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info("Update[%d]: now learning rate arrived at "
                             "%0.5e, will not change in the future",
                             num_update, self.base_lr)
            else:
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each update count in the increasing list ``step``."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list")
        for i, s in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise ValueError("Schedule step must be an increasing list")
            if s < 1:
                raise ValueError("Schedule step must be greater or equal "
                                 "than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind < len(self.step) \
                and num_update > self.step[self.cur_step_ind]:
            self.count = self.step[self.cur_step_ind]
            self.cur_step_ind += 1
            self.base_lr *= self.factor
            logging.info("Update[%d]: Change learning rate to %0.5e",
                         num_update, self.base_lr)
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay to zero over ``max_update`` updates."""

    def __init__(self, max_update, power=2.0):
        super().__init__()
        self.max_update = max_update
        self.power = power

    def __call__(self, num_update):
        if num_update >= self.max_update:
            return 0.0
        return self.base_lr * (1.0 - num_update / self.max_update) \
            ** self.power
