"""TTFT/TPOT latency predictor: the learned scorer column (port of
gie_tpu/models/latency.py).

A small MLP maps per-(request, endpoint) features to predicted (TTFT
seconds, TPOT seconds/token); the scorer column is
1 / (1 + predicted_request_latency / norm_s), in (0, 1]. The reference's
MLP is XLA, not a Pallas kernel, so its matmuls stay torch ops here; its
column joins the blend that the fused Sinkhorn and blend-top-k kernels
consume, and on CUDA it runs inside the captured scheduling cycle.

Numerics follow flax's dtype rules, not torch's defaults: params are f32;
the embedding and the hidden Dense layers cast input, kernel and bias to
bf16 and add the bias in bf16 after the product; the head runs in f32,
then softplus. The tanh GELU is jax.nn.gelu's op sequence with a bf16
rounding after each op (XLA runs it op by op; F.gelu rounds once), with
its constants rounded to bf16 as JAX rounds a weak-typed scalar. The
column still differs from the reference's by bf16 rounding inside the
products and tanh (about 1e-3 relative), so tests hold it to a tolerance
and hold the cycle exactly through a fixed column.

Params are a flat dict of f32 tensors in the module's state_dict layout
("Embed_0.weight" [M_MAX + 1, 8], "Dense_i.weight" [out, in],
"Dense_i.bias" [out]); convert.predictor_params_from_numpy /
predictor_params_to_numpy carry them to and from the reference's flax tree
(kernels [in, out]). Init draws from a torch.Generator with flax's default
distributions; it cannot repeat threefry's bits, so parity goes through
carried params.

Training is online: served-endpoint and response-timing feedback
accumulates in a host-side ring buffer (OnlineTrainer) and periodically
takes AdamW steps. The trainer steps its own module in place on a CUDA
stream of its own and then publishes a consistent copy of the params
(device tensors and host arrays, swapped whole under its lock): the
scheduler's parameter handoff, predict_ttft and the replication digest
read only published copies, never a half-stepped tree.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional

import numpy as np
import torch

from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.types import EndpointBatch, RequestBatch

NUM_FEATURES = 8

# Shared feature normalizers: build_features (device) and host_features
# (host) MUST use these same constants or online training skews against
# serving-time features.
PROMPT_NORM = 4096.0
DECODE_NORM = 1024.0
QUEUE_NORM = 64.0
RUNNING_NORM = 64.0
AGE_CLIP_S = 10.0
LOAD_NORM = 32.0

SLOT_EMBED_DIM = 8


@dataclasses.dataclass(frozen=True)
class LatencyPredictorConfig:
    hidden: int = 128
    layers: int = 2
    # Normalization for the score column:
    # score = 1 / (1 + latency / norm_s).
    norm_s: float = 2.0
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4


def _bf16_scalar(x: float) -> float:
    """`x` rounded to bf16, as a Python float: JAX rounds a weak-typed
    scalar to the array's dtype before the op, and a bf16-exact Python
    float makes torch's op (computed in f32, rounded once) do the same."""
    return float(torch.tensor(x, dtype=torch.float32).to(torch.bfloat16))


_GELU_C = _bf16_scalar(0.044715)
_SQRT_2_OVER_PI = _bf16_scalar(math.sqrt(2.0 / math.pi))


def gelu_tanh_bf16(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(x, approximate=True) on a bf16 tensor, op by op:
    0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x**3))) * x, each op
    rounded to bf16 (x**3 as JAX's integer_pow: x * (x * x))."""
    cube = x * (x * x)
    inner = x + cube * _GELU_C
    t = torch.tanh(inner * _SQRT_2_OVER_PI)
    return x * ((t + 1.0) * 0.5)


def param_shapes(cfg: "LatencyPredictorConfig") -> dict[str, tuple]:
    """{port param name: shape} of the MLP `cfg` builds, in order."""
    shapes = {"Embed_0.weight": (C.M_MAX + 1, SLOT_EMBED_DIM)}
    fan_in = NUM_FEATURES + SLOT_EMBED_DIM
    for i in range(cfg.layers):
        shapes[f"Dense_{i}.weight"] = (cfg.hidden, fan_in)
        shapes[f"Dense_{i}.bias"] = (cfg.hidden,)
        fan_in = cfg.hidden
    shapes[f"Dense_{cfg.layers}.weight"] = (2, fan_in)
    shapes[f"Dense_{cfg.layers}.bias"] = (2,)
    return shapes


def mlp_apply(params: dict, x: torch.Tensor, slots: torch.Tensor,
              layers: int) -> torch.Tensor:
    """The MLP as a function of its params: ([..., NUM_FEATURES] f32,
    slot ids [...]) -> f32[..., 2] = (ttft_s, tpot_s_per_token). Makes no
    call that waits for the device, so the scheduling cycle that runs it
    can be captured."""
    bf16 = torch.bfloat16
    table = params["Embed_0.weight"].to(bf16)
    emb = table[torch.clamp(slots, 0, C.M_MAX).long()]
    h = torch.cat([x.to(bf16), emb], dim=-1)
    for i in range(layers):
        w = params[f"Dense_{i}.weight"].to(bf16)
        b = params[f"Dense_{i}.bias"].to(bf16)
        h = gelu_tanh_bf16(torch.matmul(h, w.t()) + b)
    w = params[f"Dense_{layers}.weight"]
    out = torch.matmul(h.float(), w.t()) + params[f"Dense_{layers}.bias"]
    # softplus as jax.nn.softplus: logaddexp(x, 0).
    return torch.logaddexp(out, torch.zeros_like(out))


class LatencyMLP(torch.nn.Module):
    """([..., NUM_FEATURES], slot i32[...]) -> [..., 2] = (ttft_s,
    tpot_s_per_token).

    The slot embedding is the per-endpoint identity signal: scraped gauges
    (queue, kv) describe load but not SPEED, so on a heterogeneous fleet
    two endpoints with identical metrics can differ severalfold in
    latency; the learned embedding absorbs that per-pod bias. Index
    C.M_MAX is the "unknown endpoint" bucket (padded lanes).

    Submodule names are flax's (Embed_0, Dense_0 .. Dense_<layers>) so the
    state_dict names map one to one onto the reference's tree."""

    def __init__(self, hidden: int = 128, layers: int = 2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = layers
        self.Embed_0 = torch.nn.Embedding(C.M_MAX + 1, SLOT_EMBED_DIM)
        fan_in = NUM_FEATURES + SLOT_EMBED_DIM
        for i in range(layers):
            setattr(self, f"Dense_{i}", torch.nn.Linear(fan_in, hidden))
            fan_in = hidden
        setattr(self, f"Dense_{layers}", torch.nn.Linear(fan_in, 2))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """flax's defaults: Dense kernels lecun_normal (a normal truncated
        at two standard deviations, scaled so its std is 1/sqrt(fan_in)),
        biases zero, the embedding normal with std 1/sqrt(features)."""
        for i in range(self.layers + 1):
            dense = getattr(self, f"Dense_{i}")
            std = 1.0 / math.sqrt(dense.in_features) / .87962566103423978
            torch.nn.init.trunc_normal_(dense.weight, 0.0, std, -2.0 * std,
                                        2.0 * std, generator=generator)
            dense.bias.zero_()
        torch.nn.init.normal_(self.Embed_0.weight, 0.0,
                              1.0 / math.sqrt(SLOT_EMBED_DIM),
                              generator=generator)

    def forward(self, x: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
        return mlp_apply(dict(self.named_parameters()), x, slots, self.layers)


def build_features(reqs: RequestBatch, eps: EndpointBatch,
                   assumed_load: torch.Tensor) -> torch.Tensor:
    """Dense per-(request, endpoint) feature grid -> f32[N, M, F]:
    (prompt, decode, has-LoRA) of the request, then (queue, KV, running,
    metrics age, assumed load) of the endpoint."""
    n = reqs.valid.shape[0]
    m = eps.valid.shape[0]
    metrics = eps.metrics
    ep_feats = torch.stack([
        metrics[:, C.Metric.QUEUE_DEPTH] / QUEUE_NORM,
        metrics[:, C.Metric.KV_CACHE_UTIL],
        metrics[:, C.Metric.RUNNING_REQUESTS] / RUNNING_NORM,
        torch.clamp(metrics[:, C.Metric.METRICS_AGE_S], 0.0, AGE_CLIP_S),
        assumed_load / LOAD_NORM,
    ], dim=-1)                                                  # [M, 5]
    req_feats = torch.stack([
        reqs.prompt_len / PROMPT_NORM,
        reqs.decode_len / DECODE_NORM,
        (reqs.lora_id >= 0).to(torch.float32),
    ], dim=-1)                                                  # [N, 3]
    return torch.cat([req_feats[:, None, :].expand(n, m, 3),
                      ep_feats[None, :, :].expand(n, m, 5)], dim=-1)


class LatencyPredictor:
    """Init/apply wrapper and the scorer-column closure for the Scheduler."""

    def __init__(self, cfg: LatencyPredictorConfig = LatencyPredictorConfig()):
        self.cfg = cfg

    def module(self, seed: int = 0) -> LatencyMLP:
        """A fresh LatencyMLP, its init drawn from a CPU generator seeded
        with `seed` (so it is the same on every device)."""
        gen = torch.Generator().manual_seed(int(seed))
        return LatencyMLP(self.cfg.hidden, self.cfg.layers, generator=gen)

    def init(self, seed: int = 0, device="cpu") -> dict:
        """Fresh params (the reference's init(PRNGKey(seed)) counterpart)."""
        return {k: v.detach().to(device)
                for k, v in self.module(seed).state_dict().items()}

    def predict(self, params: dict, features, slots) -> torch.Tensor:
        """[..., NUM_FEATURES] features and [...] slots (tensors or
        arrays) -> f32[..., 2] on the params' device."""
        dev = params["Embed_0.weight"].device
        return mlp_apply(params, torch.as_tensor(features).to(dev),
                         torch.as_tensor(slots).to(dev), self.cfg.layers)

    def request_latency(self, params: dict, features, slots, decode_len):
        """Predicted end-to-end seconds: TTFT + TPOT * decode_len."""
        pred = self.predict(params, features, slots)            # [..., 2]
        return pred[..., 0] + pred[..., 1] * decode_len[..., None]


def host_features(
    metrics_row: np.ndarray,
    assumed_load: float,
    prompt_len: float,
    decode_len: float,
    has_lora: bool,
) -> np.ndarray:
    """Host-side twin of build_features for ONE (request, endpoint) pair:
    the feature row recorded at pick time for online-training feedback.
    Shares the module-level normalizers with build_features so the two
    paths cannot diverge."""
    return np.asarray(
        [
            prompt_len / PROMPT_NORM,
            decode_len / DECODE_NORM,
            1.0 if has_lora else 0.0,
            metrics_row[C.Metric.QUEUE_DEPTH] / QUEUE_NORM,
            metrics_row[C.Metric.KV_CACHE_UTIL],
            metrics_row[C.Metric.RUNNING_REQUESTS] / RUNNING_NORM,
            min(max(metrics_row[C.Metric.METRICS_AGE_S], 0.0), AGE_CLIP_S),
            assumed_load / LOAD_NORM,
        ],
        np.float32,
    )


def predictor_score_fn(predictor: LatencyPredictor):
    """Build the Scheduler's predictor_fn:
    (params, reqs, eps, assumed_load) -> f32[N, M].

    Run inside the scheduling cycle (on CUDA, the captured one); params
    are the scheduler's static buffers, which a parameter handoff copies
    into, so online training never recaptures. The live assumed-load
    vector feeds feature 7 so training and serving see the same load
    signal."""

    def fn(params: dict, reqs: RequestBatch, eps: EndpointBatch,
           assumed_load: torch.Tensor, *, col0: int = 0) -> torch.Tensor:
        feats = build_features(reqs, eps, assumed_load)
        n = reqs.valid.shape[0]
        m = eps.valid.shape[0]
        # Slot ids are GLOBAL endpoint identities regardless of the live M
        # bucket: the embedding table stays M_MAX+1 wide so a slot keeps
        # its learned bias across bucket migrations. `col0` is the global
        # slot of eps' first lane (a tp shard's, parallel/mesh.py).
        slots = torch.arange(col0, col0 + m, dtype=torch.int64,
                             device=feats.device)[None, :].expand(n, m)
        latency = predictor.request_latency(params, feats, slots,
                                            reqs.decode_len)
        # Hyperbolic, not exponential, decay: a 30 s and a 300 s forecast
        # still score different f32 values.
        return 1.0 / (1.0 + torch.clamp(latency, min=0.0)
                      / predictor.cfg.norm_s)

    return fn


# ---------------------------------------------------------------------------
# Online training
# ---------------------------------------------------------------------------


def make_train_step(predictor: LatencyPredictor):
    """AdamW step on (features[B,F], slots[B], targets[B,2], weights[B,2])
    weighted MSE -> step(module, optimizer, feats, slots, targets,
    weights) -> the loss (a 0-d tensor; read it only when needed, reading
    waits for the step). The per-column weights let partially-observed
    samples train only the heads they observed.

    The reference's step is pure (params, opt_state) -> new ones; this one
    steps `module`'s params and `optimizer`'s state in place, which is why
    OnlineTrainer publishes a copy for its readers."""
    del predictor  # the module carries the architecture

    def step(module, optimizer, feats, slots, targets, weights):
        pred = module(feats, slots)
        se = weights * (pred - targets) ** 2
        loss = se.sum() / torch.clamp(weights.sum(), min=1.0)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_optimizer(module: torch.nn.Module,
                   cfg: LatencyPredictorConfig) -> torch.optim.Optimizer:
    """optax.adamw(lr, weight_decay=wd) as torch.optim.AdamW: b1 0.9, b2
    0.999, eps 1e-8, decoupled decay on every leaf. The two agree in exact
    arithmetic and differ in operation order: optax computes
    p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), torch decays first,
    p * (1 - lr * wd), then subtracts lr / (1 - b1^t) * m / (sqrt(v) /
    sqrt(1 - b2^t) + eps); so one step differs by f32 rounding."""
    return torch.optim.AdamW(module.parameters(), lr=cfg.learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def _resolve_device(device) -> torch.device:
    from gie_tpu_torch.sched.profile import resolve_device

    return resolve_device(device)


class OnlineTrainer:
    """Host-side ring buffer + periodic train steps on the trainer's
    device (CUDA unless the caller passes device="cpu"; without a card and
    without a device it raises, as the Scheduler does).

    Observations arrive from the served-endpoint feedback path: the feature
    row used at pick time plus measured (ttft_s, tpot_s).

    Threads: train(), on the runner's train thread, steps the trainer's own
    module on its own stream and publishes a copy of the params; the
    completer's SLO admission and the autoscale probe call predict_ttft,
    which runs the published copy on another stream of its own and waits
    on its own event only; the replication digest reads the published host
    arrays. `params` is the published device copy."""

    def __init__(
        self,
        predictor: LatencyPredictor,
        seed: int = 0,
        capacity: int = 8192,
        batch_size: int = 256,
        confidence_min_samples: int = 1024,
        confidence_loss_ok: float = 0.05,
        *,
        device=None,
    ):
        self.predictor = predictor
        self.device = _resolve_device(device)
        self.confidence_min_samples = confidence_min_samples
        self.confidence_loss_ok = confidence_loss_ok
        self.module = predictor.module(seed).to(self.device)
        self.optimizer = make_optimizer(self.module, predictor.cfg)
        self._step = make_train_step(predictor)
        self._train_stream = self._predict_stream = None
        if self.device.type == "cuda":
            current = torch.cuda.current_stream(self.device)
            self._train_stream = torch.cuda.Stream(self.device)
            self._predict_stream = torch.cuda.Stream(self.device)
            self._train_stream.wait_stream(current)
            self._predict_stream.wait_stream(current)
        self.capacity = capacity
        self.batch_size = batch_size
        self._feats = np.zeros((capacity, NUM_FEATURES), np.float32)
        self._slots = np.full((capacity,), C.M_MAX, np.int32)
        self._targets = np.zeros((capacity, 2), np.float32)
        self._weights = np.zeros((capacity, 2), np.float32)
        self._n = 0
        self._head = 0
        self._observed_total = 0
        self._lock = threading.Lock()
        # Serializes everything that writes the module: train steps,
        # digest installs and checkpoint restores.
        self._train_lock = threading.Lock()
        self._rng = np.random.default_rng(seed)
        self.last_loss: Optional[float] = None
        self._loss_ema: Optional[float] = None
        self._published: dict = {}
        self._published_host: dict = {}
        self._published_seq = self._snapshots = 0
        self._publish(self._snapshot())

    # -- published params --------------------------------------------------

    @property
    def params(self) -> dict:
        """The last published params (device tensors, never written)."""
        return self._published

    def params_numpy(self) -> dict:
        """The last published params as host arrays (never written)."""
        return self._published_host

    def _stream(self, stream):
        return (contextlib.nullcontext() if stream is None
                else torch.cuda.stream(stream))

    def _snapshot(self) -> tuple:
        """Queue copies of the module's params on the train stream (device
        clones and host copies) and number them. Caller holds _train_lock
        (or owns the trainer); _publish(snapshot) then runs without it."""
        self._snapshots += 1
        with self._stream(self._train_stream):
            dev = {k: v.detach().clone()
                   for k, v in self.module.state_dict().items()}
            if self._train_stream is None:
                host = {k: v.numpy().copy() for k, v in dev.items()}
                return self._snapshots, dev, host, None
            pinned = {k: torch.empty(v.shape, dtype=v.dtype,
                                     pin_memory=True).copy_(
                                         v, non_blocking=True)
                      for k, v in dev.items()}
            done = torch.cuda.Event()
            done.record(self._train_stream)
        return self._snapshots, dev, pinned, done

    def _publish(self, snapshot: tuple) -> None:
        """Wait for a snapshot's copies (the train stream alone, holding no
        lock), then swap both copies in whole, unless a later snapshot was
        published first."""
        seq, dev, host, done = snapshot
        if done is not None:
            done.synchronize()
            host = {k: v.numpy() for k, v in host.items()}
        with self._lock:
            if seq > self._published_seq:
                self._published, self._published_host = dev, host
                self._published_seq = seq

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.require(a, requirements=("C", "W")))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- observations ------------------------------------------------------

    def observe(
        self,
        features: np.ndarray,
        ttft_s: Optional[float],
        tpot_s: Optional[float] = None,
        slot: int = C.M_MAX,
    ) -> None:
        """Record one observation. Either head may be None when that
        quantity was not measured: it is masked out of the loss for the
        sample instead of being dragged toward zero. A both-None
        observation is dropped. `slot` is the served endpoint's scheduler
        slot (feeds the per-endpoint embedding; defaults to the unknown
        bucket)."""
        if ttft_s is None and tpot_s is None:
            return
        with self._lock:
            self._feats[self._head] = features
            self._slots[self._head] = min(max(int(slot), 0), C.M_MAX)
            self._targets[self._head] = (
                ttft_s if ttft_s is not None else 0.0,
                tpot_s if tpot_s is not None else 0.0,
            )
            self._weights[self._head] = (
                0.0 if ttft_s is None else 1.0,
                0.0 if tpot_s is None else 1.0,
            )
            self._head = (self._head + 1) % self.capacity
            self._n = min(self._n + 1, self.capacity)
            self._observed_total += 1

    # Pad prediction batches to a multiple of this, as the reference pads
    # its jitted forward's batch.
    PREDICT_PAD = 64

    def predict_ttft(self, features: np.ndarray,
                     slots: np.ndarray) -> np.ndarray:
        """Predicted TTFT seconds for (feature row, slot) pairs: the
        SLO-admission signal. On CUDA the forward runs on the trainer's
        predict stream and this waits on its own event only, never behind
        the waves queued on the device."""
        b = int(features.shape[0])
        if b == 0:
            return np.zeros((0,), np.float32)
        pad = (-b) % self.PREDICT_PAD
        f = np.pad(np.asarray(features, np.float32), ((0, pad), (0, 0)))
        s = np.pad(np.asarray(slots, np.int64), (0, pad),
                   constant_values=C.M_MAX)
        params = self.params
        layers = self.predictor.cfg.layers
        stream = self._predict_stream
        if stream is None:
            with torch.no_grad():
                out = mlp_apply(params, torch.from_numpy(f),
                                torch.from_numpy(s), layers)
            return out[:b, 0].numpy()
        with torch.no_grad(), torch.cuda.stream(stream):
            out = mlp_apply(params, self._upload(f), self._upload(s),
                            layers)[:, 0]
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        return host.numpy()[:b]

    def train(self, steps: int = 1) -> Optional[float]:
        """Run up to `steps` AdamW steps if enough observations
        accumulated, then publish the params. The loss is read once, after
        the last step (the reference reads each step's and keeps the
        last)."""
        with self._lock:
            n = self._n
            if n < self.batch_size:
                return None
            feats = self._feats[:n].copy()
            slots = self._slots[:n].copy()
            targets = self._targets[:n].copy()
            weights = self._weights[:n].copy()
        loss_t = None
        with self._train_lock:
            with self._stream(self._train_stream):
                for _ in range(steps):
                    idx = self._rng.integers(0, n, self.batch_size)
                    loss_t = self._step(
                        self.module, self.optimizer,
                        self._upload(feats[idx]),
                        self._upload(slots[idx].astype(np.int64)),
                        self._upload(targets[idx]),
                        self._upload(weights[idx]))
            snapshot = self._snapshot()
        # The snapshot's event follows the last step on the train stream:
        # once it is published, the loss is computed too, and its read
        # waits on the train stream alone.
        self._publish(snapshot)
        with self._stream(self._train_stream):
            loss = None if loss_t is None else float(loss_t)
        self.last_loss = loss
        if loss is not None:
            self._loss_ema = (
                loss if self._loss_ema is None
                else 0.9 * self._loss_ema + 0.1 * loss
            )
        return loss

    def confidence(self) -> float:
        """How much the live score blend should trust the latency column,
        in [0, 1]: the phase-in gate for Scheduler.gate_latency_column.
        The product of a sample ramp (how much of the latency surface the
        buffer has seen) and a loss factor (how well the model fits it),
        so the column phases in only as the predictor converges and drops
        back if drift raises the loss EMA."""
        if self._loss_ema is None:
            return 0.0
        with self._lock:
            observed = self._observed_total
        ramp = min(1.0, observed / max(self.confidence_min_samples, 1))
        factor = min(1.0, self.confidence_loss_ok / max(self._loss_ema, 1e-9))
        return ramp * factor

    # -- replication digest surface ----------------------------------------

    def _confidence_arrays(self) -> dict:
        with self._lock:
            return {
                "loss_ema": np.float32(
                    np.nan if self._loss_ema is None else self._loss_ema),
                "observed_total": np.int64(self._observed_total),
            }

    def export_state(self) -> dict:
        """Flat array dict for the replication digest's "predictor"
        section, in the reference's keys: every param leaf of its flax
        tree keyed "param['params']['Dense_0']['kernel']" and so on, plus
        the confidence state (loss EMA and observed count), so a promoted
        follower's phase-in gate resumes where the leader left off. Reads
        the published host arrays only."""
        from gie_tpu_torch.convert import (
            flatten_predictor_tree,
            predictor_params_to_numpy,
        )

        out = flatten_predictor_tree(
            predictor_params_to_numpy(self.params_numpy()), "param")
        out.update(self._confidence_arrays())
        return out

    def prepare_install(self, arrays: dict):
        """Validation half of install_state: every param leaf of THIS
        build's architecture must be present with its exact shape (a
        digest from a differently configured predictor rejects whole);
        extra keys are ignored. Returns an opaque staged tuple for
        commit_install, or None."""
        from gie_tpu_torch.convert import predictor_leaves_from_flat

        params = predictor_leaves_from_flat(arrays, "param",
                                            self.predictor.cfg)
        if params is None:
            return None
        try:
            ema = float(np.asarray(arrays["loss_ema"]).reshape(()))
            observed = int(np.asarray(arrays["observed_total"]).reshape(()))
        except (KeyError, TypeError, ValueError):
            return None
        return (params, ema, observed)

    def _load_params(self, params: dict) -> None:
        """Copy port-layout host arrays into the module, restart the
        optimizer (as on checkpoint restore) and publish."""
        with self._train_lock:
            with torch.no_grad(), self._stream(self._train_stream):
                for k, v in self.module.state_dict().items():
                    v.copy_(self._upload(np.asarray(params[k], np.float32)))
            self.optimizer = make_optimizer(self.module, self.predictor.cfg)
            snapshot = self._snapshot()
        self._publish(snapshot)

    def commit_install(self, staged) -> None:
        """Commit half: the validated params and confidence state."""
        params, ema, observed = staged
        self._load_params(params)
        with self._lock:
            self._loss_ema = None if np.isnan(ema) else max(ema, 0.0)
            self._observed_total = max(observed, 0)

    def install_state(self, arrays: dict) -> bool:
        """Validated inverse of export_state (single-component form)."""
        staged = self.prepare_install(arrays)
        if staged is None:
            return False
        self.commit_install(staged)
        return True

    # -- durability --------------------------------------------------------

    def save(self, directory: str) -> None:
        """Checkpoint params + confidence state as the reference's
        {"params", "meta"} tree, flattened to one .npz
        (utils/checkpoint.py): keys "params['params']['Dense_0']['kernel']"
        ... and "meta['loss_ema']", "meta['observed_total']"."""
        from gie_tpu_torch.convert import (
            flatten_predictor_tree,
            predictor_params_to_numpy,
        )
        from gie_tpu_torch.utils.checkpoint import save_pytree

        tree = flatten_predictor_tree(
            predictor_params_to_numpy(self.params_numpy()), "params")
        tree.update({f"meta['{k}']": v
                     for k, v in self._confidence_arrays().items()})
        save_pytree(directory, tree)

    def restore(self, directory: str) -> bool:
        """Restore params (and confidence state) if a checkpoint exists;
        returns success. The optimizer state restarts fresh. A params-only
        checkpoint (the layout from before the confidence gate: the bare
        params tree, keys "['params']['Dense_0']['kernel']" ...) restores
        with FULL confidence: the release that wrote it applied the
        configured weight unconditionally."""
        from gie_tpu_torch.convert import predictor_leaves_from_flat
        from gie_tpu_torch.utils.checkpoint import restore_pytree_raw

        raw = restore_pytree_raw(directory)
        if raw is None:
            return False
        cfg = self.predictor.cfg
        params = predictor_leaves_from_flat(raw, "params", cfg)
        if params is not None:
            try:
                ema = float(np.asarray(raw["meta['loss_ema']"]).reshape(()))
                observed = int(np.asarray(
                    raw["meta['observed_total']"]).reshape(()))
            except (KeyError, TypeError, ValueError):
                return False
            self._load_params(params)
            with self._lock:
                self._loss_ema = None if np.isnan(ema) else ema
                self._observed_total = observed
            return True
        params = predictor_leaves_from_flat(raw, "", cfg)
        if params is None:
            return False
        self._load_params(params)
        with self._lock:
            self._loss_ema = self.confidence_loss_ok
            self._observed_total = self.confidence_min_samples
        from gie_tpu_torch.runtime.logging import get_logger

        get_logger("predictor").info(
            "legacy params-only checkpoint restored; seeding full "
            "column confidence (pre-gate behavior)", dir=directory)
        return True
