"""Adaptive hot-set coverage: route each batch to one of two engines by
its sampled cold rate.

Counterpart of datok_tpu/runtime/adaptive.py, with its surface and its
constants.  The JAX module routes between a narrow and a wide fused
engine; here both run K1, and the hot set is what differs: the narrow
engine is ``BatchEngine(tok, **engine_kwargs)``, the wide one adds
``hot_size`` = :func:`~datok_tpu_torch.runtime.hot.hot_capacity`, the
widest set one block's shared memory holds (339 states at 171 symbols).
The JAX ``WIDE_CONFIG`` (``hot_size=768, kernel_pring=256,
kernel_pool=8``) sizes the TPU kernel's set and ring; its two
``kernel_`` knobs have no counterpart in K1, which has no ring.

The deciding statistic is the fraction of transition fetches leaving
the narrow engine's hot set, measured by the exact native walk
(``native_cold_rate``) over a document sample.  With the port's default
``hot_size=0`` the narrow engine has no hot set: then, as the JAX module
does for an engine without a spec, the cold rate is 0.0 and the choice
is always the narrow engine.  So it is where the narrow set already
holds ``hot_capacity`` states: no wide engine could hold more, and a
second tagged table of the same set would buy nothing.  Per-wave sets (``BatchEngine(...,
per_wave=True)``, the default) supersede the router where a census is
available, as in the JAX package.

Both engines encode alike (the port's encoder depends on the skip
class, not on the hot set), so a batch encoded by either runs on
either; :meth:`AdaptiveEngine.choose` takes raw texts as the JAX one
does.  The wide engine is built lazily, so corpora that stay narrow
never pay for it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..utils.native import native_cold_rate
from .encode import text_to_codepoints
from .engine import BatchEngine
from .hot import hot_capacity, sample_texts

# cold-fetch fraction above which the wide engine is chosen
# (datok_tpu/runtime/adaptive.py:54)
COLD_THRESHOLD = 0.005

# per-choice sample budget: chars walked by the native scalar loop
# (datok_tpu/runtime/adaptive.py:57)
SAMPLE_CHARS = 65536


class AdaptiveEngine:
    """Two engines (narrow, and wide: the most hot states K1 holds)
    behind one choose-then-run surface."""

    def __init__(
        self,
        tok,
        threshold: float = COLD_THRESHOLD,
        sample_chars: int = SAMPLE_CHARS,
        wide_config: Optional[dict] = None,
        **engine_kwargs,
    ):
        self.tok = tok
        self.threshold = threshold
        self.sample_chars = sample_chars
        self._kwargs = engine_kwargs
        self.narrow = BatchEngine(tok, **engine_kwargs)
        self._wide_config = dict(
            {"hot_size": hot_capacity(self.narrow.tables.max_sym)}
            if wide_config is None else wide_config)
        self._wide: Optional[BatchEngine] = None
        self.last_choice = "narrow"
        self.last_cold_rate = 0.0
        hot = self.narrow.tables.hot
        if hot is not None and hot.H < hot_capacity(
                self.narrow.tables.max_sym):
            mask = np.zeros(self.narrow.tables.S + 1, dtype=np.uint8)
            mask[hot.states] = 1
            self._hot_mask = mask
        else:
            # no hot set, or the widest there is: nothing to adapt
            self._hot_mask = None

    @property
    def wide(self) -> BatchEngine:
        if self._wide is None:
            kw = dict(self._kwargs)
            kw.update(self._wide_config)
            self._wide = BatchEngine(self.tok, **kw)
        return self._wide

    def cold_rate(self, texts: Sequence[str]) -> float:
        """Sampled cold-fetch fraction of ``texts`` against the narrow
        hot set (exact native walk; 0.0 when the native library or a
        hot set is unavailable — the narrow engine is always a correct
        choice)."""
        if self._hot_mask is None:
            return 0.0
        sample = sample_texts(texts, self.sample_chars)
        if sample is None:
            return 0.0
        metas = self.narrow.encoder.encode(text_to_codepoints(sample))
        res = native_cold_rate(
            self.tok, np.asarray(metas, np.int32), self._hot_mask
        )
        if res is None:
            return 0.0
        cold, fetches = res
        return cold / max(fetches, 1)

    def choose(self, texts: Sequence[str]) -> BatchEngine:
        """Pick the engine for this batch of documents."""
        rate = self.cold_rate(texts)
        self.last_cold_rate = rate
        if rate > self.threshold:
            self.last_choice = "wide"
            return self.wide
        self.last_choice = "narrow"
        return self.narrow

    # -- convenience passthroughs (single-shot surfaces) ---------------

    def tokenize_batch(self, texts, flags=None):
        return self.choose(texts).tokenize_batch(texts, flags)

    def events_batch(self, texts):
        return self.choose(texts).events_batch(texts)
