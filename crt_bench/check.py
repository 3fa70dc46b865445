"""The comparison that decides ``correct``: what the timed path produced,
against what the plain reference (``crt_bench/reference``) works out for
the same inputs.

The system is integer throughout and states every output byte and state
word bit-exact, so the number compared is the count of elements that
differ over every field of every checked answer (the encoder's analog
field and ccf, the decoder's frame, sync estimates and noise states, the
frames back on the host), and its limit is 0.  The count of each field
is printed beside it.
"""

from __future__ import annotations

import torch

NAME = "elements_differing"
LIMIT = 0


def judge(pairs: list) -> tuple[dict, dict, int]:
    """pairs: (field, program, reference) tensors whose dim 0 counts the
    checked answers (a slot's step, a frame, a chunk).  Returns ({NAME:
    {"value": elements that differ, "limit": 0}}, {field: elements that
    differ}, answers with any difference).  A program tensor of another
    shape differs everywhere."""
    fields, bad = {}, None
    for name, prog, ref in pairs:
        prog, ref = torch.as_tensor(prog), torch.as_tensor(ref)
        if prog.shape != ref.shape:
            wrong = torch.ones(ref.shape[0], dtype=torch.bool)
            fields[name] = max(prog.numel(), ref.numel(), 1)
        else:
            diff = (prog != ref).reshape(ref.shape[0], -1)
            wrong = diff.any(dim=1)
            fields[name] = int(diff.sum())
        bad = wrong if bad is None else bad | wrong
    if bad is None:
        raise ValueError("no answer was checked")
    checks = {NAME: {"value": sum(fields.values()), "limit": LIMIT}}
    return checks, fields, int(bad.sum())


def lines(checks: dict, fields: dict) -> list[str]:
    """The count of each field, then each number compared beside its
    limit, one a line."""
    return ([" ".join(f"{n} {v}" for n, v in fields.items())]
            + [f"check {n}: {c['value']} (limit {c['limit']})"
               for n, c in checks.items()])
