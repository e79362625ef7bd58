"""The serving engine: shape-bucketed dispatch over a predictor.

Counterpart of `tensor2robot_tpu.serving.engine`. Serving traffic
arrives at every batch size; `BucketedEngine` pads each request up a
small bucket ladder so that a handful of batch shapes, each run once at
`warmup()`, cover every request size:

* a bucket ladder (default: doubling 1/2/4/.../max_batch_size), each
  rung run once at `warmup()` on a batch made from the feature spec. With
  `cache` (an `obs.excache.ExecutableCache` or a directory) each rung is
  compiled, as the JAX engine AOT-compiles one executable per rung:
  `obs.xray.analyze_jit` under `<cache_namespace>/bucket<rung>`, its
  artifacts loaded from or stored into the cache. Without one the rungs
  run eagerly, which takes cuDNN's plan selection and the caching
  allocator's growth off the first live request. `warm_count` counts
  rungs warmed and stays at `len(buckets)` across any later traffic;
  `compile_count` counts fresh compiles, `cache_loads` rungs whose
  compile found its artifacts in the cache, and `warmup_provenance`,
  `warmup_load_ms` / `warmup_compile_ms`, `compile_records`,
  `rung_traces` and `rung_cache_keys` (keys without compiling) describe
  them as the JAX engine's do;
* `predict(features)` runs the predictor's preprocess on the REAL rows,
  pads the model-layout batch on the device up to the smallest covering
  rung (pad rows repeat row 0: always in-distribution, never NaN fodder),
  runs the predict function on the state read through the bundle's
  getter at every dispatch (so a `restore()` hot swap is served without
  re-warming), fetches to the host and slices the pad rows off every
  batched output. Requests larger than the top rung are served in
  top-rung chunks and re-joined;
* no fallback at dispatch: a rung that fails there raises.

`traffic_bucket_ladder` / `ladder_padding_stats` / `observed_request_rows`
derive a ladder from observed request sizes and price it (pure Python).

Telemetry (`obs.metrics`): serve/engine/warmups, rows, padded_rows,
reladders, device_busy_ms (counters); serve/engine/predict_ms
(histogram); serve/engine/warmup_ms (gauge). Each dispatch records the
graftrace sub-stages `pad` (padding the model-layout batch up to its
rung) and `device` (the predict call through the end of its host fetch,
the fetch being the barrier) under the caller's active context
(`graftrace.current()`: the batcher's batch context), and adds `device`
to the exact `serve/engine/device_busy_ms` counter. Both stages lie
inside the batcher's `dispatch` window and are not summed. A rung whose
compile fails runs eagerly (`xray/analyze_failures`, provenance
'fallback'); a rung that fails at dispatch raises.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.obs import excache as excache_lib
from tensor2robot_tpu_torch.obs import graftrace
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.obs import trace as obs_trace
from tensor2robot_tpu_torch.obs import xray as obs_xray
from tensor2robot_tpu_torch.utils import config

__all__ = ["BucketedEngine", "bucket_ladder", "traffic_bucket_ladder",
           "ladder_padding_stats", "observed_request_rows"]


def bucket_ladder(max_batch_size: int) -> List[int]:
  """The doubling ladder 1, 2, 4, ... with max always included (a
  non-power-of-two max becomes the top rung: 12 -> [1, 2, 4, 8, 12])."""
  if max_batch_size < 1:
    raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
  ladder = []
  b = 1
  while b < max_batch_size:
    ladder.append(b)
    b *= 2
  ladder.append(max_batch_size)
  return ladder


def observed_request_rows(histogram_name: str = "serve/request_rows"
                          ) -> List[int]:
  """Observed per-request row counts from the serving telemetry stream
  (`MicroBatcher.predict` records every request's rows into the
  `serve/request_rows` histogram; the reservoir is an unbiased sample
  of the full traffic). The input side of `traffic_bucket_ladder`."""
  return [int(v) for v in obs_metrics.histogram(histogram_name).values()]


def traffic_bucket_ladder(sizes: Sequence[int],
                          max_batch_size: int,
                          min_share: float = 0.05,
                          split_waste: float = 0.25,
                          max_buckets: int = 8) -> List[int]:
  """Bucket ladder derived from OBSERVED request sizes.

  The fixed doubling ladder spends one warmed rung per power of two
  regardless of where the traffic lands; real fleets see skewed size
  mixes (a robot fleet ticking at batch 1, a CEM sweep at 24), so the
  rungs should sit where the rows are. Starting from the fixed ladder
  (`bucket_ladder`, kept verbatim when traffic is uniform):

  1. MERGE: repeatedly drop the non-top rung carrying the smallest
     traffic share below `min_share`; its requests pad up to the next
     rung.
  2. SPLIT: repeatedly insert the traffic-median size of the rung whose
     mean padded-row fraction exceeds `split_waste` (while under
     `max_buckets`).

  Merges run to fixpoint before splits (the two passes cannot cycle),
  every boundary decision is deterministic in `sizes`, and the top rung
  is always `max_batch_size` (oversize requests chunk through it, so
  they count as `max_batch_size` here). Empty `sizes` returns the fixed
  ladder."""
  if max_batch_size < 1:
    raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
  sizes = [min(int(s), max_batch_size) for s in sizes if int(s) >= 1]
  base = bucket_ladder(max_batch_size)
  if not sizes:
    return base
  ladder = list(base)

  def _assign(ladder_now: List[int]):
    by_rung: Dict[int, List[int]] = {b: [] for b in ladder_now}
    for size in sizes:
      for b in ladder_now:
        if b >= size:
          by_rung[b].append(size)
          break
    return by_rung

  # Merge pass (to fixpoint): drop under-trafficked rungs, never the top.
  while len(ladder) > 1:
    by_rung = _assign(ladder)
    total = float(len(sizes))
    droppable = [(len(by_rung[b]) / total, b) for b in ladder[:-1]
                 if len(by_rung[b]) / total < min_share]
    if not droppable:
      break
    ladder.remove(min(droppable)[1])

  # Split pass (to fixpoint): tighten rungs wasting rows on padding.
  while len(ladder) < max_buckets:
    by_rung = _assign(ladder)
    worst = None
    for b in ladder:
      rows = by_rung[b]
      if not rows:
        continue
      waste = sum((b - s) / b for s in rows) / len(rows)
      if waste > split_waste and (worst is None or waste > worst[0]):
        worst = (waste, b, rows)
    if worst is None:
      break
    rows = sorted(worst[2])
    median = rows[len(rows) // 2]
    if median in ladder or median == worst[1]:
      break
    ladder = sorted(ladder + [median])
  return ladder


def ladder_padding_stats(sizes: Sequence[int],
                         ladder: Sequence[int]) -> Dict[str, float]:
  """Padding economics of `ladder` over observed `sizes`.
  `padded_row_frac` is the fraction of dispatched rows that are padding;
  `dispatch_rows_per_row` the dispatched/requested row blow-up."""
  ladder = sorted(set(int(b) for b in ladder))
  if not ladder:
    raise ValueError("ladder must be non-empty")
  top = ladder[-1]
  sizes = [int(s) for s in sizes if int(s) >= 1]
  if not sizes:
    return {"requested_rows": 0.0, "dispatched_rows": 0.0,
            "padded_row_frac": 0.0, "dispatch_rows_per_row": 1.0,
            "buckets": float(len(ladder))}
  requested = 0
  dispatched = 0
  for size in sizes:
    requested += size
    full, rest = divmod(size, top)
    dispatched += full * top
    if rest:
      dispatched += next(b for b in ladder if b >= rest)
  return {
      "requested_rows": float(requested),
      "dispatched_rows": float(dispatched),
      "padded_row_frac": (dispatched - requested) / dispatched
      if dispatched else 0.0,
      "dispatch_rows_per_row": dispatched / requested if requested else 1.0,
      "buckets": float(len(ladder)),
  }


def _pad_rows(tensor: torch.Tensor, bucket: int) -> torch.Tensor:
  """Pads the leading dim up to `bucket` by repeating row 0 (always a
  valid, in-distribution row: zero padding can feed NaN-producing ops
  like normalizations on degenerate inputs)."""
  rows = tensor.shape[0]
  if rows == bucket:
    return tensor
  pad = tensor[:1].expand((bucket - rows,) + tuple(tensor.shape[1:]))
  return torch.cat([tensor, pad], dim=0)


@config.configurable
class BucketedEngine:
  """Shape-bucketed dispatch in front of a predictor.

  Wraps any predictor with the `serving_bundle()` seam
  (`CheckpointPredictor`). Duck-types the predictor contract, so callers
  (policies, env loops, a `MicroBatcher`) use it exactly like the
  predictor it fronts.
  """

  def __init__(self, predictor=None,
               max_batch_size: int = 8,
               buckets: Optional[Sequence[int]] = None,
               cache=None,
               cache_namespace: str = "serve/engine"):
    if predictor is None:
      raise ValueError("predictor is required.")
    self._predictor = predictor
    if buckets is not None:
      buckets = sorted(set(int(b) for b in buckets))
      if not buckets or buckets[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets}")
      max_batch_size = buckets[-1]
    else:
      buckets = bucket_ladder(max_batch_size)
    self._buckets = buckets
    self._max_batch_size = max_batch_size
    # `cache_namespace` names the compile records (and so the cache key's
    # prefix): fleet replicas share one namespace, so one entry set warms
    # every replica.
    self._cache = cache
    self._cache_namespace = cache_namespace
    self._warm: Dict[int, float] = {}  # rung -> warmup ms
    self._compiled: Dict[int, Any] = {}  # rung -> compiled predict
    self._records: Dict[int, Dict[str, Any]] = {}
    self._compile_count = 0
    self._cache_loads = 0
    self._warmup_load_ms = 0.0
    self._warmup_compile_ms = 0.0
    self._warmup_provenance: List[Dict[str, Any]] = []
    self._bundle = None
    self._lock = threading.Lock()

  # -- warmup ---------------------------------------------------------------

  @property
  def buckets(self) -> List[int]:
    return list(self._buckets)

  @property
  def warm_count(self) -> int:
    """Rungs run once at warmup. After `warmup()` this equals
    `len(buckets)` and no later request changes it."""
    return len(self._warm)

  @property
  def warmup_ms(self) -> Dict[int, float]:
    """Host wall of each rung's warmup run (preprocess, compile or cache
    load, forward, fetch)."""
    return dict(self._warm)

  @property
  def compile_count(self) -> int:
    """Fresh compiles this process paid (cache loads and eager rungs
    excluded): `len(buckets)` after a cold compiled warmup, 0 after a
    fully warm one."""
    return self._compile_count

  @property
  def cache_loads(self) -> int:
    """Rungs whose compile found its artifacts in the cache."""
    return self._cache_loads

  @property
  def warmup_load_ms(self) -> float:
    """Warmup wall of the rungs whose artifacts came from the cache."""
    return self._warmup_load_ms

  @property
  def warmup_compile_ms(self) -> float:
    """Warmup wall of the rungs compiled fresh (misses and fallbacks)."""
    return self._warmup_compile_ms

  @property
  def warmup_provenance(self) -> List[Dict[str, Any]]:
    """Per rung: `{rung, source, ms, key}`, `source` 'cache' (artifacts
    loaded), 'compile' (fresh), 'fallback' (the compile failed: eager) or
    'eager' (no cache: not compiled)."""
    return [dict(p) for p in self._warmup_provenance]

  @property
  def compile_records(self) -> List[Dict[str, Any]]:
    """Per-rung xray records (compile time, flops, roofline, ...)."""
    return [dict(self._records[b]) for b in self._buckets
            if b in self._records]

  def warmup(self) -> "BucketedEngine":
    """Runs every rung once on a wire-layout batch synthesized from the
    predictor's feature spec and put through the SAME preprocess the live
    path uses, compiling it when the engine has a cache. Idempotent;
    after a predictor `restore()` it is a no-op (shapes are stable across
    restores, only values change, and the engine reads state through the
    bundle's getter, an input of the compiled graph)."""
    with self._lock:
      if self._bundle is None:
        self._bundle = self._predictor.serving_bundle()
      did_work = False
      for bucket in self._buckets:
        if bucket not in self._warm:
          did_work = True
          self._warm_bucket_locked(bucket)
      if did_work:
        obs_metrics.gauge("serve/engine/warmup_ms").set(
            sum(self._warm.values()))
        obs_metrics.gauge("serve/engine/warmup_load_ms").set(
            self._warmup_load_ms)
        obs_metrics.gauge("serve/engine/warmup_compile_ms").set(
            self._warmup_compile_ms)
    return self

  def _rung_args(self, bucket: int) -> Tuple[Any, Any]:
    """(state, model features) a rung runs on at warmup: the one
    arg-synthesis seam of `warmup`, `rung_traces` and `rung_cache_keys`."""
    bundle = self._bundle
    wire = specs_lib.make_random_numpy(bundle.feature_spec,
                                       batch_size=bucket, seed=0)
    return bundle.get_state(), bundle.preprocess(wire)

  def _warm_bucket_locked(self, bucket: int) -> None:
    """Runs (compiles, or cache-loads) ONE rung, with its provenance."""
    bundle = self._bundle
    cache = excache_lib.as_cache(self._cache)
    start = time.perf_counter()
    state, features = self._rung_args(bucket)
    rec_name = f"{self._cache_namespace}/bucket{bucket}"
    record: Dict[str, Any] = {}
    if cache is None:
      source = "eager"
      outputs = bundle.predict_fn(state, features)
    else:
      source = "compile"
      xf = obs_xray.XrayedFunction(rec_name, bundle.predict_fn, cache=cache,
                                   model=getattr(self._predictor, "model",
                                                 None))
      outputs = xf(state, features)
      if xf.compiled:
        self._compiled[bucket] = xf
        record = xf.record
        self._records[bucket] = record
      else:
        source = "fallback"
    for value in outputs.values():
      value.cpu()  # the fetch is the barrier
    elapsed_ms = (time.perf_counter() - start) * 1e3
    self._warm[bucket] = elapsed_ms
    obs_metrics.counter("serve/engine/warmups").inc()
    cache_block = record.get("cache") or {}
    if cache_block.get("hit"):
      source = "cache"
      self._cache_loads += 1
      self._warmup_load_ms += elapsed_ms
      obs_metrics.counter("serve/engine/cache_loads").inc()
    elif source != "eager":
      self._compile_count += 1
      self._warmup_compile_ms += elapsed_ms
      obs_metrics.counter("serve/engine/compiles").inc()
    self._warmup_provenance.append(
        {"rung": bucket, "source": source, "ms": elapsed_ms,
         "key": cache_block.get("key")})

  def reladder(self, buckets: Sequence[int]) -> "BucketedEngine":
    """Atomically moves the engine onto a new bucket ladder, warming (and
    with a cache compiling) any NEW rungs BEFORE the swap, so a ladder
    change never puts a cold rung in front of live traffic. Rungs no
    longer on the ladder stay warm (a reladder back is free)."""
    buckets = sorted(set(int(b) for b in buckets))
    if not buckets or buckets[0] < 1:
      raise ValueError(f"buckets must be positive ints, got {buckets}")
    with self._lock:
      if self._bundle is None:
        self._bundle = self._predictor.serving_bundle()
      for bucket in buckets:
        if bucket not in self._warm:
          self._warm_bucket_locked(bucket)
      # Every rung warm: the swap itself is one assignment under the
      # lock — concurrent predicts see either ladder, both fully warm.
      self._buckets = buckets
      self._max_batch_size = buckets[-1]
      obs_metrics.counter("serve/engine/reladders").inc()
    return self

  def rung_traces(self) -> List[Tuple[int, Any, Tuple]]:
    """`[(rung, predict function, args), ...]` for every ladder rung:
    what each rung's warmup runs and compiles, without running it (torch
    has no trace apart from its compile)."""
    with self._lock:
      if self._bundle is None:
        self._bundle = self._predictor.serving_bundle()
      return [(bucket, self._bundle.predict_fn, self._rung_args(bucket))
              for bucket in self._buckets]

  def rung_cache_keys(self) -> Dict[int, str]:
    """The graftcache key of every rung WITHOUT compiling: the key a live
    warmup with a cache looks up (graftforge `--verify`)."""
    model = getattr(self._predictor, "model", None)
    return {bucket: obs_xray.step_cache_key(
        f"{self._cache_namespace}/bucket{bucket}", args, model)[0]
            for bucket, _, args in self.rung_traces()}

  def _bucket_for(self, rows: int) -> int:
    for bucket in self._buckets:
      if bucket >= rows:
        return bucket
    raise AssertionError(f"no bucket covers {rows} rows")  # chunked before

  # -- serving --------------------------------------------------------------

  def predict(self, features: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Bucket-padded predict; outputs match unbatched predict row for row
    (up to the numerics of the batch size the device ran).

    Oversize requests are served in top-bucket chunks and re-assembled:
    callers never see the ladder.
    """
    if not self._warm:
      self.warmup()
    features = {k: np.asarray(v) for k, v in dict(features).items()}
    rows = next(iter(features.values())).shape[0]
    if rows < 1:
      raise ValueError("request must have at least one row (got 0)")
    start = time.perf_counter()
    top = self._max_batch_size
    with obs_trace.span("serve/engine/predict", cat="serve", rows=rows):
      if rows <= top:
        result = self._predict_chunk(features, rows)
      else:
        chunks = []
        chunk_rows = []
        for offset in range(0, rows, top):
          chunk = {k: v[offset:offset + top] for k, v in features.items()}
          chunk_rows.append(next(iter(chunk.values())).shape[0])
          chunks.append(self._predict_chunk(chunk, chunk_rows[-1]))
        result = {}
        for k in chunks[0]:
          first = chunks[0][k]
          # Batched outputs (leading dim == that chunk's rows) re-join
          # across chunks; non-batched ones (scalars / fixed-size
          # diagnostics) are identical per chunk — keep the first.
          if first.ndim and first.shape[0] == chunk_rows[0]:
            result[k] = np.concatenate([c[k] for c in chunks], axis=0)
          else:
            result[k] = first
    obs_metrics.histogram("serve/engine/predict_ms").record(
        (time.perf_counter() - start) * 1e3)
    obs_metrics.counter("serve/engine/rows").inc(rows)
    return result

  def _predict_chunk(self, features: Dict[str, np.ndarray],
                     rows: int) -> Dict[str, np.ndarray]:
    bundle = self._bundle
    bucket = self._bucket_for(rows)
    # Preprocess the REAL rows only, then pad the model-layout features
    # on the device: preprocessing pad rows would multiply the per-row
    # host work by bucket/rows. Only leaves whose leading dim is the
    # batch get padded — the same shape[0] test the slice below and
    # `batcher._split_outputs` use.
    model_features = bundle.preprocess(features)
    if bucket != rows:
      # `pad` is an informational sub-stage of the batcher's dispatch
      # window (graftrace.INFO_STAGES), excluded from the reconciliation
      # sum, which would otherwise count it twice inside `dispatch`.
      pad_ns = time.perf_counter_ns()
      obs_metrics.counter("serve/engine/padded_rows").inc(bucket - rows)
      model_features = specs_lib.SpecStruct({
          k: _pad_rows(v, bucket) if v.ndim and v.shape[0] == rows else v
          for k, v in model_features.items()})
      graftrace.record_stage(
          "pad", (time.perf_counter_ns() - pad_ns) / 1e6,
          ctx=graftrace.current(), start_ns=pad_ns)
    state = bundle.get_state()
    predict_fn = self._compiled.get(bucket, bundle.predict_fn)
    device_ns = time.perf_counter_ns()
    outputs = predict_fn(state, model_features)
    # The fetch is the barrier; pad rows are sliced off AFTER it so the
    # device sees only full-rung shapes. Only outputs whose leading dim
    # IS the padded batch get sliced.
    out = {}
    for k, v in dict(outputs).items():
      v = v.cpu().numpy()
      if v.ndim and v.shape[0] == bucket:
        v = v[:rows]
      out[k] = v
    # `device` = predict call + host fetch (the real barrier): host wall
    # from launch to fetch, not kernel time; the other dispatch-internal
    # sub-stage, same exclusion rule as `pad`.
    device_ms = (time.perf_counter_ns() - device_ns) / 1e6
    graftrace.record_stage(
        "device", device_ms, ctx=graftrace.current(), start_ns=device_ns)
    # Cumulative device-occupancy counter: the engine-level busy signal
    # a usage ledger's per-group numbers cross-check against (stage
    # histograms are reservoir-sampled; this is exact).
    obs_metrics.counter("serve/engine/device_busy_ms").inc(device_ms)
    return out

  # -- predictor duck-type passthroughs -------------------------------------

  def get_feature_specification(self):
    return self._predictor.get_feature_specification()

  def restore(self) -> bool:
    ok = self._predictor.restore()
    if ok and self._bundle is not None:
      # Re-bind the bundle so a model swapped in by restore() (not just
      # new params) is picked up; warm rungs stay valid because shapes
      # and dtypes are pinned by the spec.
      self._bundle = self._predictor.serving_bundle()
    return ok

  @property
  def global_step(self) -> int:
    return self._predictor.global_step

  @property
  def model_version(self) -> int:
    return self.global_step

  def assert_is_loaded(self) -> None:
    self._predictor.assert_is_loaded()

  def close(self) -> None:
    self._predictor.close()
