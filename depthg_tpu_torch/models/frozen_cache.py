"""What a frozen backbone derives from its weights, derived once per set of
weights.

A ViT's bf16 copy of its parameters (``featurizer.bf16_parameters``), its
position table resized to a patch grid (``vit.interpolate_pos_encoding``),
its int8 copy (``vit.int8_copy``) and a BEiT block's relative position bias
for an input size (``zoedepth.beit.Attention.rel_pos_bias``) are pure
functions of tensors that do not change while the weights stand.
``derived`` keeps each such value with the live object it belongs to (the
module, or the table's tensor), keyed on the storage, version counter,
dtype and device of every tensor it was derived from:

* a load (``load_state_dict``), a move or cast (``.to()``), a replaced
  parameter or an in-place update (an optimizer step) changes the key, so
  the value is derived again, and every value of the owner's older weights
  is dropped first;
* entries live in a weak-keyed map, so they die with their owner, and an
  address reused by a later module or tensor never finds them;
* a value is derived outside inference mode, so a copy made under the eval
  CLI's ``inference_mode`` serves a later validation or train step (and its
  tensors keep a version counter to be keyed on); a source without one (an
  inference tensor) is derived on every call, kept nowhere and counted as
  a build each time;
* each owner keeps at most ``keep`` values (``KEEP`` unless the caller
  says), the least recently used dropped first: a table keeps one per grid,
  a BEiT block one bias per input size.

The callers keep nothing while gradients are on, where a gradient could
reach the source (the int8 copy is detached, so it is always kept). One
lock serves every thread (the serve dispatcher and its caller). ``COUNTS``
counts the values derived and the values served from the cache; the spans
record them as ``frozen_cache_builds`` and ``frozen_cache_hits``.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Iterable

import torch
from torch.utils.weak import WeakIdKeyDictionary

from depthg_tpu_torch.utils import profiling

# values kept per owner unless the caller says otherwise
KEEP = 4


class _Counts:
    """The values ``derived`` has built and served in this process."""

    def __init__(self):
        self.builds = 0
        self.hits = 0


COUNTS = _Counts()
profiling.register_counter("frozen_cache_builds", lambda: COUNTS.builds)
profiling.register_counter("frozen_cache_hits", lambda: COUNTS.hits)

_LOCK = threading.RLock()
# owner -> OrderedDict(tag -> (weights key, value)), least recently used first
_ENTRIES = WeakIdKeyDictionary()


def _weights_key(tensors: Iterable[torch.Tensor]) -> tuple:
    """The storage, version counter, dtype and device of each tensor."""
    return tuple((t.data_ptr(), t._version, t.dtype, t.device) for t in tensors)


def derived(owner, tag, sources: Iterable[torch.Tensor], derive: Callable,
            keep: int = KEEP):
    """``derive()``, kept with ``owner`` under ``tag`` while ``sources``
    keep their storages, versions, dtypes and devices. Every value kept
    with one owner derives from the same sources (the owner's weights)."""
    try:
        key = _weights_key(sources)
    except RuntimeError:  # an inference tensor has no version counter
        with _LOCK:
            COUNTS.builds += 1
        return derive()
    with _LOCK:
        entries = _ENTRIES.get(owner)
        if entries is None:
            entries = _ENTRIES[owner] = collections.OrderedDict()
        hit = entries.get(tag)
        if hit is not None and hit[0] == key:
            entries.move_to_end(tag)
            COUNTS.hits += 1
            return hit[1]
        # values of the owner's older weights are dead: free them (this
        # reference included) before the new value takes their memory
        hit = None
        for stale in [t for t, (k, _) in entries.items() if k != key]:
            del entries[stale]
        COUNTS.builds += 1
        with torch.inference_mode(False), torch.no_grad():
            value = derive()
        entries[tag] = (key, value)
        while len(entries) > keep:
            entries.popitem(last=False)
        return value
