"""The port's runtime flags (counterpart of ``pymra_tpu/utils/config.py``).

Every ``PYMRA_*`` environment variable the port reads is declared here, with
its default, its legal values and its purpose, and every read goes through
:func:`flag`. Flags are read at call time, not at import, so a flag set
between two sweeps takes effect in the second. ``python -m
pymra_torch.utils.config`` prints the table.

Only the flags that choose between paths of the port, and the log level,
are here; the JAX
package's TPU flags (the Pallas switches, its escalation strategy, the
whole-leaf fusion switch and the compile cache) select code that exists
only on the TPU.
"""
from __future__ import annotations

import os
from typing import NamedTuple

__all__ = ["FLAGS", "flag", "describe"]


class Flag(NamedTuple):
    name: str
    default: str
    choices: tuple | None  # None = free-form
    purpose: str


#: every runtime flag the port reads, in one place
FLAGS: dict[str, Flag] = {f.name: f for f in [
    Flag("PYMRA_LEAF_SOLVE", "auto", ("auto", "inv", "tri"),
         "Leaf solve route of the sweep (tree/sweep.py): 'inv' inverts the "
         "posterior factor once and makes every leaf solve a matmul (the "
         "fused leaf kernel K1 where it applies); 'tri' factors the "
         "posterior block (K2, KC above 64) and solves with it (K5 where "
         "16 <= P <= 64 and P + Q <= 112, else torch's solve), the prior "
         "log-determinant by K6; 'auto' takes 'inv' in the kernel "
         "structure for P >= 16, as the JAX package does on the TPU, and "
         "'tri' elsewhere."),
    Flag("PYMRA_LOG_LEVEL", "INFO", None,
         "Level of the package logger set by "
         "pymra_torch.utils.logging.configure when it is given none."),
]}


def flag(name: str) -> str:
    """The value of flag ``name`` in the environment, or its default.

    Asking for an undeclared flag raises ``KeyError``; a value outside the
    flag's choices raises ``ValueError``.
    """
    f = FLAGS[name]
    value = os.environ.get(name, f.default)
    if f.choices is not None and value not in f.choices:
        raise ValueError(f"{name}={value!r}: expected one of {f.choices}")
    return value


def describe() -> str:
    """Human-readable table of every flag, its default and its purpose."""
    lines = []
    for f in FLAGS.values():
        choices = f" {{{','.join(f.choices)}}}" if f.choices else ""
        lines.append(f"{f.name} (default {f.default!r}){choices}\n"
                     f"    {f.purpose}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(describe())
