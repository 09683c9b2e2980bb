"""Where the flagship class step spends its device time on a GPU.

Measures, on the flagship bank (64 clips, 60 s chunks at 8 kHz):

* the card's copy bandwidth (``y = x + 1`` over 1 GiB: 2 GiB moved);
* the fused lean step per chunk, streaming (one section per launch) and
  scan-batched (8 sections per launch, the default file plan's program);
* the lean candidate stage (``models/bank.py::candidate_scan`` plus the
  long-plateau flag) on each group's real (G, L) correlation, alone,
  beside its one-read bound G x L x 4 bytes at the measured bandwidth;
* profiler traces of a few streaming and scan-batched launches, reduced
  to device time per launch, per kernel, and in the kernels that the
  ``candidate_scan`` named scope became (mapped through the compiled
  program's HLO metadata).

Every time is the host clock around work that ends in
``block_until_ready``, after a warm-up call. The card's name and power
limit come from ``nvidia-smi`` and are printed beside the numbers.

Run on the card:  python scripts/profile_stages.py [--out DIR]
It refuses to run on anything but a GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def _timed(fn, *args, iters: int = 30, repeats: int = 5) -> dict[str, float]:
    """Median and spread of seconds per call, back-to-back calls."""
    jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        samples.append((time.perf_counter() - t0) / iters)
    return {
        "median_s": float(np.median(samples)),
        "min_s": float(min(samples)),
        "max_s": float(max(samples)),
    }


def copy_bandwidth() -> float:
    """Bytes per second moved by an elementwise pass (read + write)."""
    n = 1 << 28  # 1 GiB of f32
    x = jnp.zeros((n,), jnp.float32)
    f = jax.jit(lambda a: a + 1.0)
    t = _timed(f, x, iters=20)
    return 2 * 4 * n / t["median_s"]


def scoped_ops(hlo_text: str, scope: str) -> set[str]:
    """Instructions of an optimised HLO module (fusions included) whose
    own metadata, or any instruction of the computation they call, has
    ``scope`` in its op_name — the kernels a named scope became."""
    comp = None
    comp_has: dict[str, bool] = {}
    calls: dict[str, str] = {}
    own: dict[str, bool] = {}
    for line in hlo_text.splitlines():
        stripped = line.strip()
        if stripped.endswith("{") and " = " not in stripped:
            comp = stripped.split()[1 if stripped.startswith("ENTRY") else 0]
            comp = comp.lstrip("%")
            comp_has.setdefault(comp, False)
            continue
        m = re.match(r"^(?:ROOT\s+)?%?([\w.\-]+)\s*=", stripped)
        if not m:
            continue
        name = m.group(1)
        hit = scope in line
        own[name] = hit
        if hit and comp is not None:
            comp_has[comp] = True
        c = re.search(r"calls=%?([\w.\-]+)", line)
        if c:
            calls[name] = c.group(1)
    return {n for n, hit in own.items() if hit or comp_has.get(calls.get(n, ""), False)}


def trace_program(out_dir: str, tag: str, fn, args, kw, launches: int) -> dict:
    """Trace ``launches`` calls of a jitted program; device time per
    launch in total and in its ``candidate_scan`` kernels. The trace and
    the program's optimised HLO stay in ``out_dir``."""
    hlo = fn.lower(*args, **kw).compile().as_text()
    with open(os.path.join(out_dir, f"{tag}_hlo.txt"), "w") as f:
        f.write(hlo)
    ops = scoped_ops(hlo, "candidate_scan")
    jax.block_until_ready(fn(*args, **kw))
    trace_dir = os.path.join(out_dir, f"trace_{tag}")
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        for _ in range(launches):
            out = fn(*args, **kw)
        jax.block_until_ready(out)
    wall = time.perf_counter() - t0
    out = reduce_trace(trace_dir, ops, launches)
    out["traced_wall_s_per_launch"] = wall / launches
    return out


def reduce_trace(trace_dir: str, ops: set[str], launches: int) -> dict:
    """Device time per launch of a saved trace, in total and in ``ops``."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))
    prof = jax.profiler.ProfileData.from_file(paths[-1])
    # Kernels replayed from a CUDA graph carry hlo_op "command_buffer";
    # their event name is the fusion's name with "." spelled "_".
    spelled = {o.replace(".", "_") for o in ops}
    per_op: dict[str, float] = {}
    total = scan = 0.0
    for plane in prof.planes:
        if "gpu" not in plane.name.lower():
            continue
        for line in plane.lines:
            for ev in line.events:
                op = str(dict(ev.stats).get("hlo_op", ev.name))
                per_op[ev.name] = per_op.get(ev.name, 0.0) + ev.duration_ns
                total += ev.duration_ns
                if op in ops or ev.name in spelled:
                    scan += ev.duration_ns
    return {
        "launches": launches,
        "device_s_per_launch": total / launches * 1e-9,
        "candidate_scan_s_per_launch": scan / launches * 1e-9,
        "candidate_scan_kernels": len(ops),
        "top_kernels_s": [
            (k, v * 1e-9 / launches)
            for k, v in sorted(per_op.items(), key=lambda kv: -kv[1])[:15]
        ],
    }


def profile(out_dir: str, card: str, num_normal: int = 32, num_marker: int = 32) -> dict:
    """Every measurement above; also written to ``out_dir``."""
    from __graft_entry__ import _make_bank
    from audio_pattern_detector_tpu.models import bank as bank_mod
    from audio_pattern_detector_tpu.ops.correlate import bank_correlate
    from audio_pattern_detector_tpu.ops.loudness import (
        integrated_loudness_device,
        loudness_normalize_device,
    )
    from audio_pattern_detector_tpu.ops.packing import try_pack_pcm16
    from audio_pattern_detector_tpu.ops.peaks import long_plateau_present

    dev = jax.devices()[0]
    result: dict = {"card": card, "device_kind": dev.device_kind}
    bw = copy_bandwidth()
    result["copy_bandwidth_bytes_per_s"] = bw

    bank, clips = _make_bank(
        num_normal=num_normal, num_marker=num_marker, chunk_seconds=60
    )
    sr = 8000
    sw = sorted(bank.classes)[0]
    cls = bank.classes[sw]
    S = cls["section_len"]
    consts = tuple((g.corr, g.verify) for g in cls["groups"])
    rng = np.random.default_rng(0)

    def pcm_section(hit: bool) -> np.ndarray:
        x = 0.05 * rng.standard_normal(S)
        if hit:
            x[10 * sr : 11 * sr] += 0.8 * clips[0].audio
            tone = clips[num_normal].audio
            x[30 * sr : 30 * sr + len(tone)] += 0.7 * tone
        return (np.clip(np.round(x * 32768), -32768, 32767) / 32768.0).astype(np.float32)

    kw = dict(metas=bank._metas[sw], height_min=bank.height_min,
              blocked=bank._blocked, merged=bank._merged)
    for label, hit in (("noise", False), ("hits", True)):
        sec = pcm_section(hit)
        packed = jnp.asarray(try_pack_pcm16(sec))
        n = jnp.float32(S)
        stream = _timed(partial(bank_mod._class_step_fused_packed_jit, **kw),
                        packed, n, cls["loud"], consts)
        b = 8
        batch = jnp.stack([packed] * b)
        nb = jnp.full((b,), S, jnp.float32)
        scan = _timed(partial(bank_mod._class_step_scan_packed_jit, **kw),
                      batch, nb, cls["loud"], consts, iters=8)
        result[f"lean_step_{label}"] = {
            "streaming_s_per_chunk": stream,
            "scan8_s_per_chunk": {k: v / b for k, v in scan.items()},
        }

        # The candidate stage alone, on this section's real correlation.
        sec_d = jnp.asarray(sec)
        norm = loudness_normalize_device(
            sec_d, integrated_loudness_device(sec_d, S, cls["loud"]))
        stages = []
        for (kind, m, k_detect, _kv), (corr_c, _v) in zip(bank._metas[sw], consts):
            corr, valid_len = jax.jit(bank_correlate)(norm, S, corr_c)
            k_lanes = min(bank_mod._SMALL_TIER, k_detect)

            @jax.jit
            def stage(c, vl, m=m, k_lanes=k_lanes):
                idx = jnp.arange(c.shape[1], dtype=jnp.int32)[None, :]
                x = jnp.where(idx < vl, c, -jnp.inf)
                plateau = long_plateau_present(x, bank.height_min)
                return bank_mod.candidate_scan(x, m, k_lanes, bank.height_min), plateau

            t = _timed(stage, corr, valid_len)
            one_read = corr.size * 4 / bw
            stages.append({
                "kind": kind, "G": int(corr.shape[0]), "L": int(corr.shape[1]),
                "stage_s": t, "one_read_bound_s": one_read,
                "ratio_to_bound": t["median_s"] / one_read,
            })
        result[f"candidate_stage_{label}"] = stages
        print(json.dumps({label: result[f"lean_step_{label}"],
                          "stages": stages}), flush=True)

    os.makedirs(out_dir, exist_ok=True)
    packed = jnp.asarray(try_pack_pcm16(pcm_section(True)))
    args = (packed, jnp.float32(S), cls["loud"], consts)
    result["trace_streaming_hits"] = trace_program(
        out_dir, "streaming", bank_mod._class_step_fused_packed_jit, args, kw, 5)
    b = 8
    args = (jnp.stack([packed] * b), jnp.full((b,), S, jnp.float32),
            cls["loud"], consts)
    result["trace_scan8_hits"] = trace_program(
        out_dir, "scan8", bank_mod._class_step_scan_packed_jit, args, kw, 2)
    with open(os.path.join(out_dir, "profile_stages.json"), "w") as f:
        json.dump(result, f, indent=1, default=str)
    return result


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="chiprun_out", help="output directory")
    args = parser.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; JAX platform is {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {card}", flush=True)
    print(json.dumps(profile(args.out, card), default=str), flush=True)


if __name__ == "__main__":
    main()
