"""Faults planted in the program, for the tests and the calibration that
show the check catches them. Each is a context manager that patches
``ompi_tpu_torch.models.transformer`` for its duration.

- ``unchanged_state``: the training step returns its loss and leaves the
  parameters as they were;
- ``half_batch``: the training step runs on the first half of the batch,
  its mean taken over that half;
- ``late_half_batch``: as ``half_batch``, from the step's fourth call on,
  after the three that set-up runs, so that only the window's steps are
  wrong;
- ``altered_answer``: the forward's logits at position 0 are rolled by one
  along the vocabulary, so the token served there is another;
- ``reference_in_place(precision)``: the control, the plain reference at a
  lower precision in the program's place (its forward, and a step of its
  loss, gradients and SGD update).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(name: str, make):
    from ompi_tpu_torch.models import transformer as tfm

    original = getattr(tfm, name)
    setattr(tfm, name, make(original, tfm))
    try:
        yield
    finally:
        setattr(tfm, name, original)


def unchanged_state():
    def make(original, tfm):
        def make_train_step(cfg, device=None, *args, **kwargs):
            _, place = original(cfg, device, *args, **kwargs)

            def step(params, tokens, targets):
                loss, _ = tfm.loss_and_grads(params, tokens, targets, cfg)
                return loss, params

            return step, place
        return make_train_step
    return _patched("make_train_step", make)


def half_batch():
    def make(original, tfm):
        def make_train_step(cfg, device=None, *args, **kwargs):
            step, place = original(cfg, device, *args, **kwargs)

            def half(params, tokens, targets):
                b = tokens.shape[0] // 2
                return step(params, tokens[:b], targets[:b])

            return half, place
        return make_train_step
    return _patched("make_train_step", make)


def late_half_batch(after: int = 3):
    def make(original, tfm):
        def make_train_step(cfg, device=None, *args, **kwargs):
            step, place = original(cfg, device, *args, **kwargs)
            calls = []

            def late(params, tokens, targets):
                calls.append(1)
                b = tokens.shape[0] // 2 if len(calls) > after \
                    else tokens.shape[0]
                return step(params, tokens[:b], targets[:b])

            return late, place
        return make_train_step
    return _patched("make_train_step", make)


def altered_answer():
    def make(original, tfm):
        def forward(params, tokens, cfg, *args, **kwargs):
            logits = original(params, tokens, cfg, *args, **kwargs)
            logits[:, 0] = logits[:, 0].roll(1, dims=-1)
            return logits
        return forward
    return _patched("forward", make)


@contextlib.contextmanager
def reference_in_place(precision: str = "fp8"):
    from benchmark.reference import opt

    def make(original, tfm):
        def make_train_step(cfg, device=None, *args, **kwargs):
            _, place = original(cfg, device, *args, **kwargs)

            def step(params, tokens, targets):
                with opt.exact_f32():
                    loss, grads = opt.loss_and_grads(
                        params, tokens, targets, cfg.n_heads, precision)
                    opt.sgd(params, grads, cfg.lr)
                return torch.tensor(loss), params

            return step, place
        return make_train_step

    def make_forward(original, tfm):
        def forward(params, tokens, cfg, *args, **kwargs):
            with torch.no_grad(), opt.exact_f32():
                return opt.forward_logits(params, tokens, cfg.n_heads,
                                          precision)
        return forward

    with _patched("make_train_step", make), \
            _patched("forward", make_forward):
        yield


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "late_half_batch": late_half_batch,
          "altered_answer": altered_answer}
