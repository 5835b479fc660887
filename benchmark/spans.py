"""The per-step numbers of the port's spans, for the readers in
`benchmark/metrics/` (the spans themselves: `depthg_tpu_torch.utils.profiling`,
read through its `collect()` alone).

`per_step(step, name, key)`: `key` summed over the spans called `name` under
the outermost spans called `step` (those spans themselves when
`name == step`), over the number of those steps. None, so that the reader
reports nothing, when the program has no spans, no such step was recorded,
a span was dropped, a step holds no span called `name`, or a value is
missing (a stream time of a span recorded without CUDA).
"""

from __future__ import annotations


def per_step(step: str, name: str, key: str) -> float | None:
    try:
        from depthg_tpu_torch.utils import profiling
        collect = profiling.collect
    except (ImportError, AttributeError):  # a program without spans
        return None
    got = collect()
    if got["dropped"]:
        return None
    roots = {s["id"] for s in got["spans"] if s["parent"] is None and s["name"] == step}
    found = [s for s in got["spans"] if s["name"] == name and s["step"] in roots]
    if not roots or {s["step"] for s in found} != roots \
            or any(s[key] is None for s in found):
        return None
    return sum(s[key] for s in found) / len(roots)
