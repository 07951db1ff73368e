"""Model size reporting (own copy of `iip_uavsal_saliency_tpu/ops/stats.py`).

The reference's `Tools/Getmodelsize_demo.py` reports parameter and buffer
bytes per submodule. The JAX package counts them per top-level name of its
variable tree (`trunk`, `mp`, `rnn`, `conv_out_st`) across `params` and
`batch_stats`; this copy counts the same tree, which the port's state_dict
gives through `models/convert.py::to_jax_variables`, so both packages print
the same report for the same configuration.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np


def _leaves(tree: Any) -> Iterator[np.ndarray]:
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield np.asarray(tree)


def param_bytes(tree: Any) -> int:
    return int(sum(np.prod(x.shape) * x.dtype.itemsize for x in _leaves(tree)))


def model_size_report(variables: Mapping[str, Any]) -> str:
    """Per-top-level-submodule byte breakdown across all collections
    (params + batch_stats), the reference's param+buffer accounting."""
    per_module: dict[str, int] = {}
    total = 0
    for tree in variables.values():
        if not isinstance(tree, Mapping):
            continue
        for name, sub in tree.items():
            b = param_bytes(sub)
            per_module[name] = per_module.get(name, 0) + b
            total += b
    lines = ["Model size report", "-" * 44]
    for name in sorted(per_module, key=per_module.get, reverse=True):
        lines.append(f"{name:<28s} {per_module[name] / 1024 / 1024:8.2f} MB")
    lines.append("-" * 44)
    lines.append(f"{'Total':<28s} {total / 1024 / 1024:8.2f} MB")
    return "\n".join(lines)
