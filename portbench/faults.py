"""Faults planted in the timed path, for the checks' own tests: each a
context manager that breaks the port while it is open (the harness opens
it around the program's set-up and window alone), and the control, the
reference computed with float8 products in the program's place."""
from __future__ import annotations

import contextlib

import torch

from portbench import compare, generator, harness


@contextlib.contextmanager
def token_altered():
    """Every served token the engine draws is the next id after its
    argmax."""
    from repro_torch.serve import engine
    real = engine.sample_token

    def sample_token(logits, gen=None, temperature=0.0):
        return (real(logits, gen, temperature) + 1) % logits.shape[-1]

    engine.sample_token = sample_token
    try:
        yield
    finally:
        engine.sample_token = real


@contextlib.contextmanager
def half_batch():
    """The train step's gradient taken over the first half of the batch's
    rows alone, the mean over those."""
    from repro_torch.train import step
    real = step.make_grads_fn

    def make_grads_fn(*args, **kwargs):
        fn = real(*args, **kwargs)

        def half(params, tokens, labels, frontend=None):
            h = tokens.shape[0] // 2
            return fn(params, tokens[:h], labels[:h], frontend)

        return half

    step.make_grads_fn = make_grads_fn
    try:
        yield
    finally:
        step.make_grads_fn = real


@contextlib.contextmanager
def state_unchanged():
    """AdamW's update returns the state it was given: no parameter or
    moment moves, the step count alone goes on."""
    from repro_torch.optim import adamw
    real = adamw.adamw_update

    def adamw_update(params, grads, opt, tcfg, lr_fn=None, gnorm=None):
        one = torch.ones((), dtype=opt.step.dtype, device=opt.step.device)
        return params, adamw.OptState(opt.m, opt.v, opt.step + one), {}

    adamw.adamw_update = adamw_update
    try:
        yield
    finally:
        adamw.adamw_update = real


FAULTS = {"serve": {"token_altered": token_altered},
          "train": {"half_batch": half_batch,
                    "state_unchanged": state_unchanged}}


def control(cell, seed: int, device) -> dict:
    """The control's readings: the reference with float8 products in the
    program's place, held against the float32 reference on the inputs a
    run with ``seed`` makes and read as a run's check reads the program:
    a serving cell's first ``check_requests`` requests, the token the
    float8 reference puts first at each sequence's last position taken
    as served; a training cell's checked steps."""
    cfg, mix = cell.config, cell.traffic
    weights = harness.load_module("weights", cfg["family"])
    ref = harness.load_module("reference", cfg["family"])
    w = weights.make(cfg, seed, device)
    if mix["kind"] == "serve":
        vocab, block = cfg["vocab_size"], mix["check_block"]
        rows = []
        for p in generator.prompts(mix, seed, mix["check_requests"], vocab,
                                   device):
            r = ref.last_logits(cfg, w, p, block=block)
            c = ref.last_logits(cfg, w, p, precision="fp8", block=block)
            rows.append(compare.served_rows(r, c, c[:, :vocab].argmax(-1),
                                            vocab))
        return compare.served(torch.cat([g for g, _ in rows]),
                              torch.cat([e for _, e in rows]))
    batches = generator.train_batches(mix, seed, mix["checked_steps"],
                                      cfg["vocab_size"], device)
    kw = dict(steps=mix["checked_steps"], block=mix["check_block"])
    r = ref.train(cfg, w, batches, mix["optimizer"], **kw)
    c = ref.train(cfg, w, batches, mix["optimizer"], precision="fp8", **kw)
    return compare.training(c, r)
