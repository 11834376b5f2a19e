"""The drivers of the benchmark's traffic kinds, one class each.

A driver builds the program under test from a configuration and the seed
(:meth:`setup`), runs the measured window (:meth:`window`), frees the
program and judges what the window produced against the plain reference
(:meth:`check`). It talks to the program only through its public entry
points: ``InferenceEngine.stream`` for a bulk job, ``BatchingFrontend`` for
online serving, a model's own forward (``DehazePhysical.forward`` for DCPDN)
for a bulk loop of fixed batches, and ``cli/train``'s step (``make_gd_steps``
with the ``ImagePool``) for training. What a configuration's model gives
them, and its plain reference, come from its family file,
``models/<model>.py`` (``harness/specs.py``).

Every driver runs on the CPU too (the port's plain twins stand in for its
kernels there), which is how the CPU tests drive whole runs at tiny sizes.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import time
from types import ModuleType
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from harness import check, counts, reference, stats, traffic, weights
from harness.trace import Spans

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
ORDER_LEN = 200_000  # images a bulk window's order covers before it repeats (>= 51 s at 3,900 img/s)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """A seeded uniform sample of ``k`` items from a stream (algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen = k, [], 0
        self._rng = traffic.rng(seed, 5)

    def offer(self, make) -> None:
        """Count one item; ``make()`` builds it only where it is kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = int(self._rng.integers(self.seen))
            if j < self.k:
                self.items[j] = make()


class Driver:
    """What every kind shares: the configuration, the traffic mix, the seed,
    the device, the model families (``families(name)``, as
    ``Specs.family``) and the configuration's own, the harness's host
    spans."""

    def __init__(self, config: dict, mix: dict, seed: int, device, families: Callable[[str], ModuleType],
                 spans: Optional[Spans] = None):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = torch.device(device)
        self.spans = spans or Spans(False)
        self.families = families
        self.family = families(config["model"])
        self.layout = weights.spec(self.family.template(),
                                   {k: tuple(v) for k, v in config.get("init", {}).items()})

    def weights(self, dtype) -> Dict[str, torch.Tensor]:
        return weights.make(self.layout, self.seed, self.device, dtype)

    def reference_weights(self) -> Dict[str, torch.Tensor]:
        """The weights as the reference reads them: the program's served
        values (made in the served dtype) in float32."""
        dtype = DTYPES[self.mix.get("precision", "fp32")]
        return {k: v.float() for k, v in weights.make(self.layout, self.seed, self.device, dtype).items()}

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        for name in list(vars(self)):
            if name.startswith("prog_"):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# --- image answers -----------------------------------------------------------------------

class _Images(Driver):
    """Shared by the kinds whose answers are images: the image pool, the
    sample of answers and the comparison with the reference."""

    def _images(self) -> None:
        m = self.mix
        self.h, self.w = m["image_h"], m["image_w"]
        self.images = traffic.images_uint8(self.seed, m["distinct_images"], self.h, self.w, self.device)
        mult = self.config["multiple"]
        self.count_hw = (-(-self.h // mult) * mult, -(-self.w // mult) * mult)
        self.flops_per_image = counts.forward_flops(self.family, self.layout, 1, *self.count_hw)

    def reference_levels(self, img_ids, q=reference.identity, block: int = 4) -> List[torch.Tensor]:
        """The reference's unrounded levels for each image id, cropped, on
        the host; in blocks of ``block`` images."""
        p = self.reference_weights()
        pad = self.mix.get("bucket", self.config["multiple"])
        out = []
        with torch.no_grad(), reference.exact():
            for i in range(0, len(img_ids), block):
                ids = list(img_ids[i:i + block])
                x = torch.from_numpy(self.images[ids]).to(self.device).float() / 255.0
                y = self.family.reference(p, reference.padded(x, pad), "running", q)
                out += list(reference.to_levels(y[:, :self.h, :self.w]).cpu())
        return out

    def _gaps(self, ids, answers) -> Dict[str, tuple]:
        """Each answer's RMS gap in levels to the reference, over the gap of
        the reference computed with bf16 convolution operands and its answer
        rounded as the program's is: the gap a sound bf16 program shows on
        this model and image, which swings from seed to seed with the random
        weights. The worst answer's ratio is compared; its gap in levels is
        a reading."""
        ref = self.reference_levels(ids)
        emu = self.reference_levels(ids, reference.bf16)
        gaps = [check.image_gap(a, r) for a, r in zip(answers, ref)]
        ratios = [g / max(check.image_gap(check.quantise(e / 127.5 - 1.0), r), 1e-6)
                  for g, e, r in zip(gaps, emu, ref)]
        w = int(np.argmax(ratios))
        return {"rms_gap_ratio": (ratios[w], f"image {ids[w]}"),
                "rms_gap_levels": (max(gaps), f"image {ids[int(np.argmax(gaps))]}")}

    def check(self) -> Dict[str, tuple]:
        """The worst sampled answer's gap ratio, and the answers that never
        came."""
        if not self.sample:
            return {"rms_gap_ratio": (float("inf"), "no answers sampled"), "answers_missing": (self.missing, "")}
        ids = [img for img, _ in self.sample]
        out = self._gaps(ids, [torch.from_numpy(np.asarray(y)) for _, y in self.sample])
        out["answers_missing"] = (self.missing, "")
        return out

    def control(self, n: int) -> Dict[str, tuple]:
        """The same numbers for the reference computed in fp8 in the
        program's place, on ``n`` images drawn from the seed."""
        self._images()
        ids = list(traffic.rng(self.seed, 6).choice(len(self.images), size=n, replace=False))
        low = [check.quantise(lv / 127.5 - 1.0) for lv in self.reference_levels(ids, reference.fp8)]
        out = self._gaps(ids, low)
        out["answers_missing"] = (0, "")
        return out


class BulkEngine(_Images):
    """A closed bulk loop through ``InferenceEngine.stream``, as ``cli/serve
    --inDir`` runs it: images offered as fast as the engine takes them,
    results consumed in order."""

    def setup(self) -> None:
        from fdgan_tpu_torch.serve import InferenceEngine

        m = self.mix
        self._images()
        self.prog_engine = InferenceEngine(
            self.family.program(self.weights(DTYPES[m["precision"]]), self.device, m), device=self.device,
            precision=m["precision"], bn_mode=m["bn_mode"], bucket=m["bucket"], batch_sizes=tuple(m["batch_sizes"]),
            input=m["input"], output=m["output"])
        top = max(m["batch_sizes"])
        self.prog_engine.warmup([(self.h, self.w)], batch=top)
        for _ in self.prog_engine.stream((self.images[i % len(self.images)] for i in range(2 * top * m["depth"])),
                                         depth=m["depth"], max_wait=m["max_wait"]):
            pass
        bucket = m["bucket"]
        self.launch_shape = (top, -(-self.h // bucket) * bucket, -(-self.w // bucket) * bucket)

    def window(self, seconds: float) -> dict:
        m = self.mix
        eng = self.prog_engine
        idx = traffic.order(self.seed, ORDER_LEN, len(self.images))
        res = Reservoir(m["check_images"], self.seed)
        t0 = time.time()
        t_end = t0 + seconds

        def offered():
            i = 0
            while time.time() < t_end:
                yield self.images[idx[i % ORDER_LEN]]
                i += 1

        done_at = []
        with self.spans.span("stream"):
            for k, y in enumerate(eng.stream(offered(), depth=m["depth"], max_wait=m["max_wait"])):
                done_at.append(time.time())
                if done_at[-1] <= t_end:
                    res.offer(lambda: (int(idx[k % ORDER_LEN]), y))
        self.sample, self.missing = res.items, 0
        self.attempted, self.failed = len(done_at), 0
        done = sum(1 for t in done_at if t <= t_end)
        return {"img_s": stats.rate(done_at, t0, t_end), "images_done": done, "window_s": seconds, "t0": t0,
                "t1": t_end, "flops_per_image": self.flops_per_image, "launch_shape": self.launch_shape}


class BulkForward(_Images):
    """A closed bulk loop of fixed batches through a model's forward (its
    family's ``forward``), staged as the engine stages: uint8 batches
    gathered into pinned host memory, a ``non_blocking`` copy up, the
    forward, the image quantised to uint8 on the device and copied back into
    pinned memory, ``in_flight`` batches in flight."""

    def setup(self) -> None:
        m = self.mix
        self._images()
        self.prog_model = self.family.program(self.weights(DTYPES[m["precision"]]), self.device, m)
        b = m["batch"]
        pin = self.device.type == "cuda"
        self.prog_stage = [torch.empty((b, self.h, self.w, 3), dtype=torch.uint8, pin_memory=pin)
                           for _ in range(m["in_flight"] + 1)]
        self.prog_out = [torch.empty((b, self.h, self.w, 3), dtype=torch.uint8, pin_memory=pin)
                         for _ in range(m["in_flight"] + 1)]
        for i in range(2 * (m["in_flight"] + 1)):
            _, event = self._dispatch(i, np.arange(i * b, (i + 1) * b) % len(self.images))
            if event is not None:
                event.synchronize()
        self.launch_shape = (b, self.h, self.w)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return check.quantise(self.family.forward(self.prog_model, x, self.mix))

    def _dispatch(self, k: int, ids: np.ndarray):
        """Batch ``k`` of images ``ids``: staged, uploaded, run, its result
        copy started. Returns (host result, event or None)."""
        n = len(self.prog_stage)
        stage, out = self.prog_stage[k % n], self.prog_out[k % n]
        with self.spans.span("stage"):
            np.take(self.images, ids, axis=0, out=stage.numpy())
        with torch.inference_mode(), self.spans.span("dispatch"):
            y = self._forward(stage.to(self.device, non_blocking=True))
            if self.device.type != "cuda":
                out.copy_(y)
                return out, None
            out.copy_(y, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return out, event

    def window(self, seconds: float) -> dict:
        m = self.mix
        b = m["batch"]
        idx = traffic.order(self.seed, ORDER_LEN, len(self.images))
        res = Reservoir(m["check_images"], self.seed)
        pending: collections.deque = collections.deque()
        done_at = []
        k = 0
        t0 = time.time()
        t_end = t0 + seconds

        def drain():
            ids, host, event = pending.popleft()
            with self.spans.span("fetch"):
                if event is not None:
                    event.synchronize()
            done_at.extend([time.time()] * len(ids))
            if done_at[-1] <= t_end:
                for slot, i in enumerate(ids):
                    # a sampled answer leaves the batch's buffer before the buffer is reused
                    res.offer(lambda i=i, slot=slot: (int(i), host[slot].numpy().copy()))

        while time.time() < t_end:
            ids = idx[np.arange(k * b, (k + 1) * b) % ORDER_LEN]
            host, event = self._dispatch(k, ids)
            pending.append((ids, host, event))
            k += 1
            while len(pending) >= m["in_flight"]:
                drain()
        while pending:
            drain()
        self.sample = res.items
        self.missing, self.attempted, self.failed = 0, k * b, 0
        done = sum(1 for t in done_at if t <= t_end)
        return {"img_s": stats.rate(done_at, t0, t_end), "images_done": done, "window_s": seconds, "t0": t0,
                "t1": t_end, "flops_per_image": self.flops_per_image, "launch_shape": self.launch_shape}


class OpenLoop(_Images):
    """Open-loop arrivals at a fixed rate into ``BatchingFrontend``: each
    request is submitted at its due time, whatever the backlog, and timed
    from its due time to its result."""

    def setup(self) -> None:
        from fdgan_tpu_torch.serve import InferenceEngine
        from fdgan_tpu_torch.serve_http import BatchingFrontend

        m = self.mix
        self._images()
        self.prog_engine = InferenceEngine(
            self.family.program(self.weights(DTYPES[m["precision"]]), self.device, m), device=self.device,
            precision=m["precision"], bn_mode=m["bn_mode"], bucket=m["bucket"], batch_sizes=tuple(m["batch_sizes"]),
            input=m["input"], output=m["output"])
        self.prog_engine.warmup([(self.h, self.w)])
        self.prog_frontend = BatchingFrontend(self.prog_engine, max_wait=m["max_wait"], depth=m["depth"])
        for f in [self.prog_frontend.submit(self.images[i % len(self.images)]) for i in range(16)]:
            f.result(timeout=600)

    def window(self, seconds: float, rate: Optional[float] = None) -> dict:
        m = self.mix
        rate = m["rate"] if rate is None else rate
        due = traffic.arrivals(self.seed, rate, seconds)
        idx = traffic.order(self.seed, len(due), len(self.images))
        n = len(due)
        pick = set(traffic.rng(self.seed, 7).choice(n, size=min(m["check_requests"], n), replace=False).tolist())
        done: List[Optional[float]] = [None] * n
        late = np.zeros(n)
        futures = {}
        eng = self.prog_engine
        before = dict(eng.stats)
        t0 = time.time()

        def finished(i):
            def cb(f):
                done[i] = time.time() if f.exception() is None else None
            return cb

        with self.spans.span("arrivals"):
            for i in range(n):
                wait = t0 + due[i] - time.time()
                if wait > 0:
                    time.sleep(wait)
                late[i] = time.time() - (t0 + due[i])
                f = self.prog_frontend.submit(self.images[idx[i]])
                f.add_done_callback(finished(i))
                if i in pick:
                    futures[i] = f
        t_close = t0 + max(seconds, float(due[-1]))
        waited_until = t_close + m["drain_s"]
        with self.spans.span("drain"):
            while any(d is None for d in done) and time.time() < waited_until:
                time.sleep(0.01)
        after = dict(eng.stats)
        failed = sum(1 for d in done if d is None)
        lat = stats.latencies([t0 + u for u in due], done, t0, t_close, waited_until)
        self.sample = []
        for i, f in sorted(futures.items()):
            try:
                self.sample.append((int(idx[i]), f.result(timeout=0)))
            except Exception:  # an answer that never came, or failed: what check() counts
                pass
        self.missing, self.attempted, self.failed = failed, n, failed
        self.lateness = late
        batches = after["batches"] - before["batches"]
        return {"latency_p95_ms": 1000 * stats.percentile(lat, 95), "latency_p50_ms": 1000 * stats.percentile(lat, 50),
                "window_s": t_close - t0, "t0": t0, "t1": t_close, "rate": rate, "offered": n,
                "completed_by_close": sum(1 for d in done if d is not None and d <= t_close),
                "batch_images": after["images"] - before["images"], "batches": batches,
                "late_p95_ms": 1000 * stats.percentile(late, 95), "late_max_ms": 1000 * float(late.max())}

    def close(self) -> None:
        if hasattr(self, "prog_frontend"):
            self.prog_frontend.close()


# --- training ------------------------------------------------------------------------------

class Train(Driver):
    """``cli/train``'s streaming step at ``--deviceSteps 0``: ``make_gd_steps``
    with the ``ImagePool``, each step uploading a seeded host batch. Set-up
    builds the training state once, runs it through its first steps (the
    checked ones, through the window's own call and feed, on batches that
    all differ) and hands the same state to the window."""

    def setup(self) -> None:
        from fdgan_tpu_torch.losses.composite import LossWeights
        from fdgan_tpu_torch.train.loop import create_train_state, make_gd_steps
        from fdgan_tpu_torch.train.pool import ImagePool

        m = self.mix
        self._inputs()
        state, tx_g, tx_d = create_train_state(self.seed, lr_g=m["lr"], lr_d=m["lr"], beta1=m["betas"][0],
                                               device=self.device)
        state.g.load_state_dict(self.weights(torch.float32))
        state.d.load_state_dict(weights.make(self.d_layout, self.seed, self.device, salt=1))
        lw = m["loss_weights"]
        self.prog_steps = make_gd_steps(tx_g, tx_d, LossWeights(adv=lw["adv"], pixel=lw["pixel"], ssim=lw["ssim"]),
                                        None, DTYPES[m["precision"]], impl="kernels")
        self.prog_state, self.prog_pool = state, ImagePool(m["pool_size"], seed=self.seed)
        self.flops_per_step = counts.train_step_flops(self.layout, self.d_layout, m["batch"], m["image"], m["image"],
                                                      lw)
        self.launch_shape = (m["batch"], m["image"], m["image"])
        self.seen = self._checked_steps()
        for j in range(m["warm_steps"]):
            self._step(m["checked_steps"] + j)
        _sync(self.device)

    def _inputs(self) -> None:
        """D's weight layout and the host batches."""
        m = self.mix
        self.d_layout = weights.spec(self.families("fdgan_d").template())
        self.haze, self.gt = traffic.train_batches(self.seed, m["distinct_batches"], m["batch"], m["image"],
                                                   self.device)

    def _step(self, j: int):
        """Step on host batch j (mod the pool of batches), as the CLI runs it."""
        g_step, d_step = self.prog_steps
        i = j % len(self.haze)
        with self.spans.span("upload"):
            haze = torch.from_numpy(np.ascontiguousarray(self.haze[i], np.float32)).to(self.device)
            gt = torch.from_numpy(np.ascontiguousarray(self.gt[i], np.float32)).to(self.device)
        with self.spans.span("g_step"):
            state, g_metrics, x_hat = g_step(self.prog_state, haze, gt)
        with self.spans.span("d_step"):
            state, d_metrics = d_step(state, self.prog_pool.query(x_hat), gt)
        return g_metrics, d_metrics

    def _checked_steps(self) -> dict:
        """The first ``checked_steps`` steps, and what the check reads of them:
        the losses, the gradient each Adam got at the first step (from its
        first moment), the change of every leaf after the last."""
        st = self.prog_state
        beta1 = self.mix["betas"][0]
        before = {"g": _leaves(st.g), "d": _leaves(st.d)}
        losses, grads = [], None
        for j in range(self.mix["checked_steps"]):
            g_metrics, d_metrics = self._step(j)
            losses.append((float(g_metrics["g_total"]), float(d_metrics["d_total"])))
            if grads is None:
                grads = {part: {n: opt.state[p]["exp_avg"].detach().cpu() / (1.0 - beta1)
                                for n, p in mod.named_parameters() if p in opt.state}
                         for part, mod, opt in (("g", st.g, st.g_opt), ("d", st.d, st.d_opt))}
        after = {"g": _leaves(st.g), "d": _leaves(st.d)}
        change = {part: {k: after[part][k] - before[part][k] for k in before[part]} for part in ("g", "d")}
        return {"losses": losses, "grads": grads, "change": change}

    def window(self, seconds: float) -> dict:
        m = self.mix
        host = []
        j = m["checked_steps"] + m["warm_steps"]
        steps = 0
        t0 = time.time()
        t_end = t0 + seconds
        while time.time() < t_end:
            t = time.perf_counter()
            self._step(j + steps)
            host.append(time.perf_counter() - t)
            steps += 1
        with self.spans.span("sync"):
            _sync(self.device)
        t1 = time.time()
        self.attempted, self.failed, self.missing = steps, 0, 0
        return {"train_img_s": steps * m["batch"] / (t1 - t0), "steps_done": steps, "window_s": t1 - t0,
                "t0": t0, "t1": t1, "host_step_s": host, "flops_per_step": self.flops_per_step,
                "launch_shape": self.launch_shape}

    def _reference_run(self, q, rows: Optional[int] = None) -> dict:
        """The reference's checked steps from the seed's weights, with
        quantiser ``q``, on the first ``rows`` rows of each batch (all where
        None)."""
        m = self.mix
        g = {k: v.clone() for k, v in self.weights(torch.float32).items()}
        d = {k: v.clone() for k, v in weights.make(self.d_layout, self.seed, self.device, salt=1).items()}
        before = {"g": {k: v.clone() for k, v in g.items()}, "d": {k: v.clone() for k, v in d.items()}}
        batches = [(torch.from_numpy(self.haze[j][:rows]).to(self.device),
                    torch.from_numpy(self.gt[j][:rows]).to(self.device)) for j in range(m["checked_steps"])]
        cfg = {"lr": m["lr"], "betas": m["betas"], "loss_weights": m["loss_weights"], "bn_momentum": m["bn_momentum"]}
        with reference.exact():
            losses, first = reference.train_steps(g, d, batches, cfg, q)
        change = {part: {k: (now[k] - before[part][k]).cpu() for k in now} for part, now in (("g", g), ("d", d))}
        return {"losses": losses, "grads": {p: {k: v.cpu() for k, v in first[p].items()} for p in ("g", "d")},
                "change": change}

    def check(self) -> Dict[str, tuple]:
        return check.train_numbers(self.seen, self._reference_run(reference.identity))

    def control(self, n: int = 0) -> Dict[str, tuple]:
        """The same numbers for the reference computed in fp8 in the
        program's place."""
        self._inputs()
        ref = self._reference_run(reference.identity)
        return check.train_numbers(self._reference_run(reference.fp8), ref)

    def half_batch(self) -> Dict[str, tuple]:
        """The same numbers for the reference in the program's place with
        half of each batch left out, the mean taken over the rest."""
        self._inputs()
        ref = self._reference_run(reference.identity)
        return check.train_numbers(self._reference_run(reference.identity, self.mix["batch"] // 2), ref)


def _leaves(module) -> Dict[str, torch.Tensor]:
    """Parameters and running statistics of ``module``, copied to the host."""
    return {k: v.detach().float().cpu().clone() for k, v in module.state_dict().items()}


KINDS = {"bulk_engine": BulkEngine, "bulk_forward": BulkForward, "open_loop": OpenLoop, "train": Train}


@contextlib.contextmanager
def driver(config: dict, mix: dict, seed: int, device, families: Callable[[str], ModuleType],
           spans: Optional[Spans] = None):
    """The driver of ``mix``'s kind, closed on exit; ``families`` gives a
    model's family module by name (``Specs.family``)."""
    d = KINDS[mix["kind"]](config, mix, seed, device, families, spans)
    try:
        yield d
    finally:
        if hasattr(d, "close"):
            d.close()
        d.free()

