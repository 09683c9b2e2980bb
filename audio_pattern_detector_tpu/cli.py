"""CLI entry point: ``audio-pattern-detector-tpu match | show-config``.

Flag-for-flag parity with the reference CLI
(reference: audio_pattern_detector/cli.py). Heavy modules import lazily so
``--help`` stays fast.
"""

import argparse
import sys


def _lazy_cmd_match(args: argparse.Namespace) -> None:
    from audio_pattern_detector_tpu.utils.compile_cache import (
        enable_persistent_cache,
    )

    enable_persistent_cache()
    from audio_pattern_detector_tpu.match import cmd_match

    return cmd_match(args)


def _lazy_cmd_serve(args: argparse.Namespace) -> None:
    from audio_pattern_detector_tpu.utils.compile_cache import (
        enable_persistent_cache,
    )

    enable_persistent_cache()
    from audio_pattern_detector_tpu.serve import cmd_serve

    return cmd_serve(args)


def _lazy_cmd_show_config(args: argparse.Namespace) -> None:
    from audio_pattern_detector_tpu.match import cmd_show_config

    return cmd_show_config(args)


def main() -> None:
    parser = argparse.ArgumentParser(
        prog="audio-pattern-detector-tpu",
        description="Accelerator-native audio pattern detection tools",
    )
    subparsers = parser.add_subparsers(dest="command", help="Available commands")

    match_parser = subparsers.add_parser("match", help="Find pattern matches in audio files")
    match_parser.add_argument(
        "--pattern-file",
        metavar="pattern file",
        required=False,
        type=str,
        action="append",
        help="pattern file (can be specified multiple times)",
    )
    match_parser.add_argument(
        "--pattern-folder",
        metavar="pattern folder",
        required=False,
        type=str,
        action="append",
        help=(
            "folder with pattern audio clips (can be specified multiple times, "
            "can be combined with --pattern-file)"
        ),
    )
    match_parser.add_argument(
        "audio_file",
        nargs="*",
        default=None,
        type=str,
        help=(
            "audio file(s) to find pattern in (omit when using --stdin or "
            "--multiplexed-stdin). With multiple files the pattern bank is "
            "loaded and compiled once and the files scan sequentially, "
            "emitting one start/end JSONL block per file"
        ),
    )
    match_parser.add_argument(
        "--stdin", action="store_true", help="read audio from stdin in WAV format"
    )
    match_parser.add_argument(
        "--multiplexed-stdin",
        action="store_true",
        help=(
            "read patterns and audio from stdin using multiplexed protocol "
            "(always outputs JSONL). Protocol: [uint32 num_patterns] then for each "
            "pattern [uint32 name_len][name][uint32 data_len][wav_data], followed by "
            "audio stream (WAV)"
        ),
    )
    match_parser.add_argument(
        "--target-sample-rate",
        metavar="rate",
        type=int,
        required=False,
        help="target sample rate for processing in Hz (default: 8000)",
    )
    match_parser.add_argument(
        "--timestamp-format",
        choices=["ms", "formatted", "both"],
        default="both",
        help=(
            'timestamp format in JSONL output: "both" for integer milliseconds and '
            'HH:MM:SS.mmm strings (default), "ms" for integer milliseconds only, '
            '"formatted" for HH:MM:SS.mmm strings only'
        ),
    )
    match_parser.add_argument(
        "--chunk-seconds",
        metavar="seconds",
        type=str,
        default=None,
        help=(
            "seconds per chunk for sliding window. Default: 60 for stdin "
            "(live) streams; for whole files the engine keeps 60 s chunks "
            "and auto-batches up to 8 consecutive chunks per device launch "
            "(identical detections — results are chunk-size- and "
            "batch-invariant — but fewer launches; since a file scan emits "
            "as it processes, the only latency cost is up to 8 min between "
            "event flushes). Pass an explicit value to disable auto-perf "
            'sizing and batching, or "auto" to use the minimum chunk the '
            "patterns allow (integers < 1 also select that minimum, "
            "matching the reference engine)"
        ),
    )
    match_parser.add_argument(
        "--debug",
        action=argparse.BooleanOptionalAction,
        help="debug mode (audio file only)",
        default=False,
    )
    match_parser.add_argument(
        "--debug-dir",
        metavar="dir",
        type=str,
        default="./tmp",
        help="base directory for debug output (default: ./tmp)",
    )
    match_parser.add_argument(
        "--height-min",
        metavar="height",
        type=float,
        default=None,
        help="override minimum correlation peak height (default: 0.25, lower to find weak matches)",
    )
    match_parser.add_argument(
        "--pipeline-depth",
        metavar="chunks",
        type=int,
        default=None,
        help=(
            "maximum chunks kept in flight on the device (default: 3). "
            "Deeper pipelines raise streaming throughput on remote "
            "runtimes without deferring emission: completed results are "
            "collected eagerly in order, so each chunk's events fire as "
            "soon as its device program finishes"
        ),
    )
    match_parser.add_argument(
        "--offline-batch",
        metavar="chunks",
        type=int,
        default=None,
        help=(
            "file mode only: scan the whole file through the batched device "
            "path, N chunks per launch (streaming-identical results, higher "
            "throughput; events emitted after the scan)"
        ),
    )
    match_parser.add_argument(
        "--stream-batch",
        metavar="chunks",
        type=int,
        default=1,
        help=(
            "run N consecutive chunks per device launch in the streaming "
            "loop (default: 1 for stdin; whole files auto-batch up to 8 "
            "when --chunk-seconds is unset). Amortises per-launch round "
            "trips on remote runtimes; identical results, but live "
            "emission is deferred to batch boundaries — up to N x "
            "chunk-seconds of added latency (e.g. 8 x 60 s = 8 min), so "
            "keep N=1 for latency-sensitive live streams"
        ),
    )
    match_parser.add_argument(
        "--stream-batch-mode",
        choices=("scan", "vmap"),
        default="scan",
        help=(
            "batched program for --stream-batch: 'scan' (sequential "
            "in-launch, one-chunk memory; default) or 'vmap' (chunks in "
            "parallel, higher memory and throughput). Identical results"
        ),
    )
    match_parser.add_argument(
        "--offline-batch-mode",
        choices=("vmap", "scan"),
        default="scan",
        help=(
            "how --offline-batch packs chunks into a launch: 'scan' (default) "
            "runs them sequentially inside one launch (one-chunk memory, "
            "per-launch overhead amortised), 'vmap' computes them in "
            "parallel (higher memory). Identical results"
        ),
    )
    match_parser.add_argument(
        "--mesh-time",
        metavar="devices",
        type=int,
        default=None,
        help=(
            "shard the scan across N devices along time: N consecutive "
            "chunks process concurrently with halo-exchanged lookback "
            "(identical detections). Events are emitted once per N-chunk "
            "slab — up to N x chunk-seconds of added latency. Requires N "
            "(x --mesh-bank) available devices; incompatible with "
            "--debug/--offline-batch/--stream-batch/--pipeline-depth"
        ),
    )
    match_parser.add_argument(
        "--mesh-bank",
        metavar="devices",
        type=int,
        default=1,
        help=(
            "with --mesh-time: additionally shard the pattern bank across "
            "N devices (mesh uses N x mesh-time devices; identical "
            "detections)"
        ),
    )
    match_parser.add_argument(
        "--mesh-stream",
        metavar="devices",
        type=int,
        default=1,
        dest="mesh_stream",
        help=(
            "scan MULTIPLE audio files concurrently, rows partitioned "
            "across N devices (data parallelism over files; N devices "
            "scan N files at full per-device rate). Output is byte-"
            "identical to the sequential multi-file run at the same "
            "--chunk-seconds: one JSONL block per file, in argument "
            "order. Requires 2+ audio files; "
            "incompatible with --stdin/--debug/--profile/--offline-batch/"
            "--stream-batch/--mesh-time/--checkpoint-file"
        ),
    )
    match_parser.add_argument(
        "--checkpoint-file",
        metavar="path",
        type=str,
        default=None,
        help=(
            "persist O(1) resume state to this file after every chunk "
            "and resume from it when it already exists (re-feed the "
            "same source; the already-processed audio is skipped and "
            "events continue where the interrupted run stopped — use "
            "the same --chunk-seconds when resuming). Removed on a "
            "clean end of stream. Single audio file or stdin only; "
            "incompatible with --debug/--offline-batch/--mesh-time"
        ),
    )
    match_parser.add_argument(
        "--profile",
        action="store_true",
        default=False,
        help="print per-stage wall-clock stats (JSON) to stderr after the run",
    )
    match_parser.add_argument(
        "--trace-dir",
        metavar="dir",
        type=str,
        default=None,
        help="write a jax.profiler device trace of the run to this directory",
    )
    match_parser.set_defaults(func=_lazy_cmd_match)

    serve_parser = subparsers.add_parser(
        "serve",
        help=(
            "serve the pattern bank to concurrent TCP audio streams "
            "(one chip, N live streams, one compiled program)"
        ),
    )
    serve_parser.add_argument(
        "--pattern-file",
        metavar="pattern file",
        required=False,
        type=str,
        action="append",
        help="pattern file (can be specified multiple times)",
    )
    serve_parser.add_argument(
        "--pattern-folder",
        metavar="pattern folder",
        required=False,
        type=str,
        action="append",
        help=(
            "folder with pattern audio clips (can be specified multiple "
            "times, can be combined with --pattern-file)"
        ),
    )
    serve_parser.add_argument(
        "--host",
        metavar="host",
        type=str,
        default="127.0.0.1",
        help="bind address (default: 127.0.0.1)",
    )
    serve_parser.add_argument(
        "--port",
        metavar="port",
        type=int,
        default=7342,
        help="TCP port to listen on (default: 7342; 0 picks a free port)",
    )
    serve_parser.add_argument(
        "--max-streams",
        metavar="n",
        type=int,
        default=8,
        help=(
            "concurrent client streams batched into each device launch "
            "(default: 8). Extra connections are refused with a JSONL "
            "error event"
        ),
    )
    serve_parser.add_argument(
        "--tile",
        metavar="n",
        type=int,
        default=None,
        help=(
            "max rows per device launch: each round's ACTIVE rows "
            "compact into a greedy width-ladder decomposition of tiles "
            "(the tile width plus every power of two below it), so "
            "device time and upload bytes scale with round occupancy "
            "while compile time and device memory stay bounded by the "
            "tile (default: min(16, max-streams))"
        ),
    )
    serve_parser.add_argument(
        "--target-sample-rate",
        metavar="rate",
        type=int,
        required=False,
        help="target sample rate for processing in Hz (default: 8000)",
    )
    serve_parser.add_argument(
        "--timestamp-format",
        choices=["ms", "formatted", "both"],
        default="both",
        help="timestamp format in JSONL events (same as match)",
    )
    serve_parser.add_argument(
        "--chunk-seconds",
        metavar="seconds",
        type=int,
        default=None,
        help=(
            "seconds per chunk per stream (default: 60, the live-stream "
            "default). Smaller chunks lower detection latency; larger "
            "chunks raise per-stream throughput"
        ),
    )
    serve_parser.add_argument(
        "--height-min",
        metavar="height",
        type=float,
        default=None,
        help=(
            "override minimum correlation peak height (default: 0.25, "
            "lower to find weak matches)"
        ),
    )
    serve_parser.add_argument(
        "--pipeline-depth",
        metavar="rounds",
        type=int,
        default=2,
        help=(
            "device rounds kept in flight while sockets ingest "
            "(default: 2)"
        ),
    )
    serve_parser.add_argument(
        "--dispatch-defer-ms",
        metavar="ms",
        type=float,
        default=50.0,
        help=(
            "hold a device round back up to this long while other live "
            "streams are mid-chunk, so rounds run at full slot occupancy "
            "(a width-B round costs the same at any fill). Adds at most "
            "this much per-chunk latency. 0 disables (default: 50)"
        ),
    )
    serve_parser.add_argument(
        "--idle-timeout",
        metavar="seconds",
        type=float,
        default=0,
        help=(
            "drop a connection that sends no data for this many seconds "
            "(it holds a stream slot other clients could use). "
            "0 disables (default)"
        ),
    )
    serve_parser.add_argument(
        "--stats-interval",
        metavar="seconds",
        type=float,
        default=0,
        help=(
            "print one JSON ops line to stderr every N seconds (window "
            "throughput, rounds, live streams, detections, pipeline "
            "occupancy). 0 disables (default)"
        ),
    )
    serve_parser.add_argument(
        "--mesh-stream",
        metavar="N",
        type=int,
        default=None,
        help=(
            "partition the stream slots across N devices (data "
            "parallelism over streams: each serving round's batch rows "
            "land on their owning chips; results identical to "
            "single-device serving). --max-streams must be divisible "
            "by N"
        ),
    )
    serve_parser.set_defaults(func=_lazy_cmd_serve)

    show_config_parser = subparsers.add_parser(
        "show-config", help="Show computed configuration for a pattern file"
    )
    show_config_parser.add_argument(
        "pattern_file", metavar="pattern file", type=str, help="pattern file"
    )
    show_config_parser.add_argument(
        "--target-sample-rate",
        metavar="rate",
        type=int,
        required=False,
        help="target sample rate for processing in Hz (default: 8000)",
    )
    show_config_parser.set_defaults(func=_lazy_cmd_show_config)

    args = parser.parse_args()
    if not args.command:
        parser.print_help()
        sys.exit(1)
    args.func(args)


if __name__ == "__main__":
    main()
