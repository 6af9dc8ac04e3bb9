"""The benchmark's harness: one cell of `BENCHMARK.json` run from its data
files.

A cell names a configuration (`configs/<name>.json`: the program's
`ModelConfig` fields under "model", the published sizes beside them, the
token ids prompts are drawn from, and the name of its family's plain
reference, `reference/<reference>.py`, and work count,
`roofline/<reference>.py`), a traffic mix (`traffic/<name>.json`, read by
`schedule` and `prompts`) and its limits (`limits/<cell>.json`).  Every
metric is a reader of its own, `metrics/<metric>.py`, with `read(readings)
-> float or None`.  Nothing here names a cell, a configuration or a metric.

A run: weights made on the device from the seed (`make_weights`) and handed
to the program by its parameter names; every call shape of the mix warmed
up; then one client in a closed loop for `seconds` (`closed_loop`), each
call `forward(tokens, logits_mode="last")` under `no_grad` with the flash
hook installed, the next call sent once the last-position logits of the
previous one are on the host; with `trace`, one cycle of the mix profiled
after the window (`trace.profile_calls`); then the check (`check`): a
sample of the window's calls, drawn from the seed and holding its longest
prompts, against the plain float32 reference.
"""
from __future__ import annotations

import importlib.util
import json
import math
import pkgutil
import statistics
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

#: top-level module names that no run may load (the JAX stack and the JAX
#: package the program was ported from), compared whole
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
#: weight views start on multiples of this many elements (256 bytes in bf16)
ALIGN = 128
#: calls of the window that the check compares with the reference
CHECKED_CALLS = 6


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path) -> ModuleType:
    """The Python file `path` as a module (file names here may hold dots
    and dashes, so they are loaded by path, not imported by name)."""
    name = "portbench_file_" + "".join(c if c.isalnum() else "_"
                                       for c in Path(path).stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of `BENCHMARK.json` with everything its files hold."""
    name: str
    chips: int
    config: dict                  # configs/<config>.json
    traffic: dict                 # traffic/<traffic>.json
    limits: dict                  # limits/<cell>.json
    reference: ModuleType         # reference/<reference>.py
    work: Callable                # roofline/<reference>.py's work()
    end_to_end: List[dict]        # BENCHMARK.json entries this cell reports
    per_layer: List[dict]
    readers: Dict[str, Callable]  # metric name -> read(readings)

    @property
    def model(self) -> dict:
        """The program's configuration."""
        return self.config["model"]

    @property
    def reference_model(self) -> dict:
        """The reference's: the program's, with the published values of the
        keys the program is given otherwise ("reference_keys")."""
        return dict(self.model, **self.config.get("reference_keys", {}))


def cell_names(root: Path) -> List[str]:
    return [w["name"] for w in load_json(root / "BENCHMARK.json")
            ["workloads"]]


def load_cell(root: Path, name: str) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, its files found by the
    names the manifest gives."""
    root = Path(root)
    bench = root / "portbench"
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = load_json(root / entry["file"])
    e2e = manifest["end_to_end"]
    per_layer = [m for m in manifest["per_layer"] if name in m["workloads"]]
    readers = {m["name"]: load_module(bench / "metrics"
                                      / f"{m['name']}.py").read
               for m in e2e + per_layer}
    return Cell(name=name, chips=w["chips"], config=config,
                traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(bench / "limits" / f"{name}.json"),
                reference=load_module(bench / "reference"
                                      / f"{config['reference']}.py"),
                work=load_module(bench / "roofline"
                                 / f"{config['reference']}.py").work,
                end_to_end=e2e, per_layer=per_layer, readers=readers)


# --------------------------------------------------------------------------
# seeds, weights, prompts
# --------------------------------------------------------------------------
def derive(seed: int, *keys) -> int:
    """A 63-bit seed for the stream `keys` of the run seed `seed` (any
    whole number)."""
    words = [seed % 2 ** 64] + [zlib.crc32(k.encode()) if isinstance(k, str)
                                else int(k) for k in keys]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


_DTYPES = {"bfloat16": torch.bfloat16}
_BULK = ("normal", "one_plus_normal")


def _small_init(init, shape, gen, device) -> torch.Tensor:
    """A parameter not drawn from the normal buffer, in float32: a constant,
    log(U[lo, hi]) (Mamba-2's A_log), or the inverse softplus of
    dt = exp(U[log lo, log hi]) (its dt_bias)."""
    kind = init[0]
    if kind == "const":
        return torch.full(shape, float(init[1]), device=device)
    u = torch.rand(shape, generator=gen, dtype=torch.float64, device=device)
    if kind == "log_uniform":
        return torch.log(init[1] + u * (init[2] - init[1])).float()
    if kind == "softplus_inv_log_uniform":
        lo, hi = math.log(init[1]), math.log(init[2])
        dt = torch.exp(lo + u * (hi - lo)).clamp_min(1e-4)
        return (dt + torch.log(-torch.expm1(-dt))).float()
    raise ValueError(f"unknown init {init!r}")


def make_weights(params: dict, dtype: torch.dtype, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: tensor} in `dtype` on `device` for the reference's `PARAMS`
    ({name: (shape, init)}), drawn from `seed` by a generator on the
    device: every normal parameter is a view of one buffer filled by one
    `randn` call, then scaled (and shifted by 1 for norm scales); the few
    small ones (`_small_init`) are drawn one by one."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights"))
    offsets, total = {}, 0
    for name, (shape, init) in params.items():
        if init[0] in _BULK:
            offsets[name] = total
            total += -(-math.prod(shape) // ALIGN) * ALIGN
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    out = {}
    for name, (shape, init) in params.items():
        if name in offsets:
            v = flat[offsets[name]:offsets[name] + math.prod(shape)] \
                .view(shape)
            v.mul_(init[1])
            if init[0] == "one_plus_normal":
                v.add_(1.0)
        else:
            v = _small_init(init, tuple(shape), gen, device).to(dtype)
        out[name] = v
    return out


def schedule(traffic: dict) -> List[Tuple[int, int]]:
    """The call shapes [(B, S)] of one cycle of the mix, shortest first.

    Prompt lengths are log-normal ("median", log-space "sigma"), cut to
    ["min", "max"] and rounded up to a multiple of "multiple" (the length
    buckets).  A call packs prompts of one bucket up to "tokens_per_call":
    B = tokens_per_call // S.  So a length's share of the calls is its
    share of the prompt tokens: the calls' lengths follow the length-biased
    distribution, log-normal with its log-mean raised by sigma^2, and call
    k of the "calls_per_cycle" takes its quantile (k + 1/2) /
    calls_per_cycle.  Every seed has the same calls."""
    mix = (traffic["loop"], traffic["clients"], traffic["tokens"],
           traffic["lengths"]["dist"])
    if mix != ("closed", 1, "uniform", "lognormal"):
        raise ValueError(f"no generator for traffic {mix}")
    ln, k = traffic["lengths"], traffic["calls_per_cycle"]
    mu = math.log(ln["median"]) + ln["sigma"] ** 2
    out = []
    for i in range(k):
        z = statistics.NormalDist().inv_cdf((i + 0.5) / k)
        s = min(max(math.exp(mu + ln["sigma"] * z), ln["min"]), ln["max"])
        s = math.ceil(s / ln["multiple"]) * ln["multiple"]
        out.append((max(1, traffic["tokens_per_call"] // s), s))
    return out


def prompts(seed: int, traffic: dict, ids: int, stream: str):
    """-> prompt(i): the token ids [B, S] (int64, on the host) of call `i`
    of the stream `stream`, uniform over [0, ids).  Calls go in cycles of
    `schedule(traffic)`, each cycle in its own order drawn from the seed;
    the same seed gives the same prompts.  One client in a closed loop is
    the only mix the harness drives."""
    shapes = schedule(traffic)

    def prompt(i: int) -> torch.Tensor:
        cycle, j = divmod(i, len(shapes))
        order = np.random.default_rng(derive(seed, stream, "order", cycle))
        shape = shapes[order.permutation(len(shapes))[j]]
        gen = torch.Generator().manual_seed(derive(seed, stream, i))
        return torch.randint(0, ids, shape, generator=gen)
    return prompt


# --------------------------------------------------------------------------
# the program
# --------------------------------------------------------------------------
def program(model_cfg: dict, weights: Dict[str, torch.Tensor]):
    """-> call(tokens) -> last-position logits [B, V] on the device: the
    program's model with `weights` assigned by parameter name (the names
    and shapes must match exactly) and the flash-attention hook
    installed."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import forward, init_model
    mc = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in model_cfg.items()})
    model = init_model(mc, device="meta")
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    have = {n: tuple(t.shape) for n, t in weights.items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:8]
        raise RuntimeError(f"the program's parameters differ from the "
                           f"reference's: {diff}")
    model.load_state_dict(weights, strict=True, assign=True)
    model.requires_grad_(False)
    flash_ops.install()

    def call(tokens):
        with torch.no_grad():
            return forward(model, mc, {"tokens": tokens},
                           logits_mode="last")[:, 0]
    return call


def set_up(cell: Cell, seed: int, device: torch.device):
    """-> (weights, the program's call, the window's prompts) of `cell` on
    `seed`, after one warm-up call of every shape of the mix."""
    t, m = cell.traffic, cell.model
    weights = make_weights(cell.reference.PARAMS(m), _DTYPES[m["param_dtype"]],
                           seed, device)
    call = program(m, weights)
    warm = prompts(seed, t, cell.config["token_ids"], "warmup")
    for i in range(len(schedule(t))):
        call(warm(i)).to("cpu")
    return weights, call, prompts(seed, t, cell.config["token_ids"], "calls")


def counters() -> Dict[str, int]:
    """The program's kernel launch counters ("<kernel package>.<key>")."""
    import repro_torch.kernels as kernels
    out = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        try:
            mod = importlib.import_module(
                f"repro_torch.kernels.{info.name}.kernel")
        except ModuleNotFoundError:
            continue
        for k, v in getattr(mod, "LAUNCHES", {}).items():
            out[f"{info.name}.{k}"] = v
    return out


# --------------------------------------------------------------------------
# the window
# --------------------------------------------------------------------------
@dataclass
class Window:
    """The closed loop's calls: host-clock seconds from each call's
    submission to its logits on the host, and to `forward` returning."""
    latency_s: List[float] = field(default_factory=list)
    enqueue_s: List[float] = field(default_factory=list)
    shapes: List[Tuple[int, int]] = field(default_factory=list)
    outputs: List[torch.Tensor] = field(default_factory=list)
    seconds: float = 0.0          # first submission to last logits back
    counters: Dict[str, int] = field(default_factory=dict)

    @property
    def calls(self) -> int:
        return len(self.latency_s)

    @property
    def tokens(self) -> int:
        return sum(b * s for b, s in self.shapes)


def closed_loop(call, prompt, seconds: float) -> Window:
    """One client: submit call i, wait for its logits on the host, submit
    call i + 1, while the window (`seconds` from the first submission) is
    open.  The window's length runs to the last call's logits."""
    w = Window()
    before = counters()
    t_start = time.perf_counter()
    t_end = t_start + seconds
    t_done = t_start
    i = 0
    while True:
        tokens = prompt(i)
        t0 = time.perf_counter()
        if t0 >= t_end:
            break
        out = call(tokens)
        t1 = time.perf_counter()
        w.outputs.append(out.to("cpu", copy=True))
        t_done = time.perf_counter()
        w.latency_s.append(t_done - t0)
        w.enqueue_s.append(t1 - t0)
        w.shapes.append(tuple(tokens.shape))
        i += 1
    w.seconds = t_done - t_start
    after = counters()
    w.counters = {k: after[k] - before.get(k, 0) for k in after}
    return w


# --------------------------------------------------------------------------
# the check
# --------------------------------------------------------------------------
def compare(prog: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """The numbers compared for logits rows `prog` (the program's) against
    `ref` (the reference's, float32), each the worst row's:
    logit_rms_rel, |prog - ref| over |ref - mean(ref)| (2-norms a row);
    logit_max_rel, the largest |prog - ref| over the row's standard
    deviation of ref."""
    p = prog.float().to(ref.device)
    diff = p - ref
    centred = ref - ref.mean(-1, keepdim=True)
    rms = diff.norm(dim=-1) / centred.norm(dim=-1)
    mx = diff.abs().amax(-1) / ref.std(-1)
    return {"logit_rms_rel": rms.max().item(),
            "logit_max_rel": mx.max().item()}


def worst(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    """The larger of each number of `a` and `b`; NaN wins."""
    out = dict(a)
    for k, v in b.items():
        old = out.get(k, -math.inf)
        out[k] = v if math.isnan(v) or v > old else old
    return out


def check_sample(seed: int, shapes: List[Tuple[int, int]]) -> List[int]:
    """The calls the check compares: the first of the longest prompts among
    the finished calls `shapes`, and `CHECKED_CALLS` - 1 more drawn from
    the seed."""
    if not shapes:
        return []
    longest = max(range(len(shapes)), key=lambda i: (shapes[i][1], -i))
    rest = [i for i in range(len(shapes)) if i != longest]
    rng = np.random.default_rng(derive(seed, "check"))
    more = rng.choice(len(rest), size=min(CHECKED_CALLS - 1, len(rest)),
                      replace=False)
    return sorted([longest] + [rest[j] for j in more])


def reference_logits(cell: Cell, weights, tokens, precision="float32"):
    """The plain reference's last-position logits [B, V] for `tokens`, in
    float32 with TF32 off (or the control's `precision`)."""
    from portbench.reference.plain import Products, float32_exact
    with torch.no_grad(), float32_exact():
        return cell.reference.forward_last(weights, cell.reference_model,
                                           tokens, Products(precision))


def check(cell: Cell, weights, prompt, window: Window, seed: int,
          device) -> Dict[str, float]:
    """The compared numbers over the sampled calls of the window."""
    got: Dict[str, float] = {}
    for i in check_sample(seed, window.shapes):
        ref = reference_logits(cell, weights, prompt(i).to(device))
        got = worst(got, compare(window.outputs[i], ref))
        del ref
    return got


# --------------------------------------------------------------------------
# one run
# --------------------------------------------------------------------------
@dataclass
class Readings:
    """What the metric readers read."""
    cell: Cell
    setup_s: float
    window: Window
    trace: Optional[object] = None     # trace.Trace of the profiled stretch
    traced_shapes: List[Tuple[int, int]] = field(default_factory=list)

    def work(self, shapes: List[Tuple[int, int]]) -> dict:
        """The cell's `work` summed over calls of `shapes`: the operations,
        and every attention layer's and SSD scan's shapes."""
        out = {"flops": 0, "flash": [], "ssd": []}
        for b, s in shapes:
            w = self.cell.work(self.cell.model, b, s)
            for k in out:
                out[k] += w[k]
        return out


def read_metrics(entries: List[dict], readings: Readings) -> dict:
    """{name: {"value", "unit"}} of the metrics in `entries` whose readers
    found something to read."""
    out = {}
    for m in entries:
        v = readings.cell.readers[m["name"]](readings)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def device_fields(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def _number(v: float):
    """`v`, or None where it is not finite (JSON has no NaN)."""
    return v if math.isfinite(v) else None


def forbidden_modules(modules) -> List[str]:
    """The names in `modules` whose top-level name (before the first dot)
    is one of `FORBIDDEN_MODULES`, compared whole."""
    return sorted(m for m in modules
                  if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t0: float):
    """One run of `cell` -> (the result line's object, the check's lines
    for standard error).  `t0`: the process's start on `perf_counter`."""
    from portbench import trace as tracing
    weights, call, prompt = set_up(cell, seed, device)
    setup_s = time.perf_counter() - t0

    window = closed_loop(call, prompt, seconds)
    dev = device_fields(device, cell.chips)
    readings = Readings(cell, setup_s, window)
    if trace:
        traced = prompts(seed, cell.traffic, cell.config["token_ids"],
                         "traced")
        tokens = [traced(i) for i in range(len(schedule(cell.traffic)))]
        readings.trace = tracing.profile_calls(call, tokens)
        readings.traced_shapes = [tuple(t.shape) for t in tokens]
        dev.update(busy_s=readings.trace.busy_s,
                   window_s=readings.trace.window_s)
    result = {"correct": False, "attempted": window.calls,
              "failed": sum(not bool(torch.isfinite(o).all())
                            for o in window.outputs),
              "metrics": read_metrics(
                  cell.per_layer if trace else cell.end_to_end, readings),
              "device": dev}
    if trace:
        result["breakdown"] = readings.trace.breakdown()

    t_check = time.perf_counter()
    got = check(cell, weights, prompt, window, seed, device)
    limits = cell.limits["limits"]
    ok = all(got.get(k, math.nan) <= lim for k, lim in limits.items())
    result["correct"] = bool(ok and result["failed"] == 0
                             and window.calls > 0)
    result["info"] = {"calls": window.calls, "window_s": window.seconds,
                      "check_s": time.perf_counter() - t_check,
                      "checked_calls": len(check_sample(seed,
                                                        window.shapes))}
    result["check"] = {k: {"value": _number(got.get(k, math.nan)),
                           "limit": lim} for k, lim in limits.items()}
    lines = [f"check {k} {got.get(k, math.nan)!r} limit {lim!r}"
             for k, lim in limits.items()]
    return result, lines
