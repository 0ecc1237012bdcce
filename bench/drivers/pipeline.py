"""Driver of a text-conditioned DiT sampled through the port's
``FlexiPipeline.sample``: one client asking for a batch of images of one
prompt, batch after batch.

Set-up builds the pipeline and samples one batch, which captures the
plan's runner (the first call runs eagerly, then captures). The window
opens on an idle device and ends at the first batch boundary after
``seconds``, so ``img_per_s`` counts whole batches; each batch ends when
its images are on the device (a synchronisation, as the client waits).
A batch's prior and its prompt's text embeddings are drawn on the device
from the seed; the prompt's length is drawn from the mix, and the
embeddings past it are zero, as a padded prompt's would be.

The output check recomputes ``images`` images, drawn from the seed among
those the window finished, with the plain reference.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from benchlib import ledger, port, traffic, weights
from benchlib.compare import rel_err
from benchlib.trace import Tracer

WARM = 1 << 20          # the warm-up batch's index: no window batch's


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        self.obs: Dict[str, Any] = {}
        self.outputs: Dict[int, torch.Tensor] = {}
        self.attempted = 0
        self.failed = 0

    def setup(self) -> None:
        from repro_torch.pipeline import FlexiPipeline, SamplingPlan

        ctx, mix, m = self.ctx, self.ctx.mix, self.ctx.model
        self.params = weights.make(m, ctx.seed, ctx.device,
                                   getattr(torch, m["param_dtype"]))
        self.pipe = FlexiPipeline(self.params, port.model_config(m),
                                  port.schedule(ctx.config["diffusion"]),
                                  device=ctx.device)
        p = mix["plan"]
        self.plan = SamplingPlan(T=p["T"], budget=p["budget"],
                                 solver=p["solver"],
                                 guidance_scale=p["guidance_scale"],
                                 lora=p["lora"],
                                 attn_backend=p["attn_backend"])
        self.prepare_inputs()
        self._sample(WARM)
        ctx.weights = self.params
        self._sync()

    def prepare_inputs(self) -> None:
        ctx, m = self.ctx, self.ctx.model
        dit = m["dit"]
        self.B = ctx.mix["batch"]
        self.stream = traffic.Stream(ctx.mix, ctx.seed)
        self.priors = traffic.DeviceDraws(
            ctx.seed, "priors", (self.B,) + tuple(dit["latent_shape"]),
            ctx.device, chunk=4)
        self.texts = traffic.DeviceDraws(
            ctx.seed, "text", (dit["text_len"], dit["text_dim"] or m["d_model"]),
            ctx.device, chunk=4)

    def _sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def inputs(self, b: int):
        """Batch ``b``'s prior [B, *latent] and text [B, T, dc]: one
        prompt, zero past its length."""
        text = self.texts[b].clone()
        text[self.stream.prompt_len(b):] = 0.0
        return self.priors[b], text[None].expand(self.B, *text.shape)

    def _sample(self, b: int) -> torch.Tensor:
        x_T, text = self.inputs(b)
        return self.pipe.sample(self.plan, self.B, None, cond=text,
                                x_T=x_T).x0

    def window(self, tracer: Tracer) -> None:
        ctx = self.ctx
        built0 = port.built(self.pipe)
        if ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(ctx.device)
        trace_batches = ctx.mix.get("trace_batches", 1 << 30)
        tracer.start()
        t0 = ctx.clock()
        self.obs["t_open"] = t0
        tracer.open_window()
        b = 0
        traced = 0
        while True:
            with tracer.span("bench.sample"):
                x0 = self._sample(b)
            with tracer.span("bench.sync"):
                self._sync()
            self.outputs[b] = x0
            b += 1
            if tracer.active:
                traced = b
                if b >= trace_batches:
                    tracer.stop()
            if ctx.clock() >= t0 + ctx.seconds:
                break
        tracer.stop()
        self.obs["window_s"] = ctx.clock() - t0
        self.obs["batches"] = b
        self.obs["traced_batches"] = traced
        self.obs["batch"] = self.B
        self.obs["completed"] = b * self.B
        self.obs["built_in_window"] = port.built(self.pipe) - built0
        if ctx.device.type == "cuda":
            self.obs["peak_bytes_window"] = torch.cuda.max_memory_allocated(
                ctx.device)
        self.attempted = b * self.B

    def close(self) -> None:
        self.outputs = {b: x.detach().clone() for b, x in self.outputs.items()}
        del self.pipe
        port.free_device()

    def check_ids(self) -> List[tuple]:
        """(batch, row) pairs of the images checked: batches drawn from
        the seed, rows spread over the batch from a drawn offset."""
        n = self.ctx.mix["check"]["images"]
        batches = traffic.check_sample(self.ctx.seed, {0: list(self.outputs)},
                                       n)
        off = traffic.check_sample(self.ctx.seed + 1,
                                   {0: list(range(self.B))}, 1)[0]
        return [(b, (off + j * self.B // n) % self.B)
                for j, b in enumerate(batches)]


def run(ctx) -> Run:
    r = Run(ctx)
    r.setup()
    return r


def reference_outputs(ctx, r: Run, pairs: List[tuple],
                      precision: str = "float32") -> Dict[tuple, torch.Tensor]:
    """The plain reference's x0 of the given (batch, row) images, one
    image at a time."""
    ref, m, p = ctx.reference, ctx.model, ctx.mix["plan"]
    phases = ledger.resolve_schedule(m, p["T"], p["budget"],
                                     p["guidance_scale"] != 0.0)
    model = ref.DiT(m, ctx.weights, ctx.device, precision=precision)
    out = {}
    for b, row in pairs:
        x_T, text = r.inputs(b)
        out[(b, row)] = ref.flow_euler(model, x_T[row:row + 1],
                                       text[row:row + 1], phases, p["T"])
    del model
    return out


def check(ctx, r: Run) -> Dict[str, Any]:
    pairs = r.check_ids()
    ref = reference_outputs(ctx, r, pairs)
    errs = {pr: rel_err(r.outputs[pr[0]][pr[1]:pr[1] + 1], ref[pr])
            for pr in pairs}
    return {"x0_rel_err": max(errs.values()) if errs else float("inf"),
            "failed": float(r.failed), "checked": len(pairs),
            "errors": {f"{b}.{row}": e for (b, row), e in errs.items()}}


def control_reading(ctx, precision: str) -> float:
    """The reference at ``precision`` put in the program's place: its
    widest x0 error against the float32 reference over the first
    ``images`` batches' first images."""
    r = Run(ctx)
    r.prepare_inputs()
    ctx.weights = weights.make(ctx.model, ctx.seed, ctx.device,
                               getattr(torch, ctx.model["param_dtype"]))
    pairs = [(b, 0) for b in range(ctx.mix["check"]["images"])]
    low = reference_outputs(ctx, r, pairs, precision)
    ref = reference_outputs(ctx, r, pairs)
    return max(rel_err(low[pr], ref[pr]) for pr in pairs)
