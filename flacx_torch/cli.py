"""Command-line interface: ``python -m flacx_torch encode in.wav out.flac``,
``python -m flacx_torch decode in.flac out.wav`` and ``python -m
flacx_torch encode-corpus outdir/ a.wav b.wav ...``.

The JAX package's ``encode``, ``decode`` and ``encode-corpus`` subcommands
with every flag, default, metavar and check, and the same completion
prints; one addition to each, ``--device {cuda,cpu}``, picks the torch
device (the card by default; ``cpu`` runs each kernel's plain PyTorch
version).
"""

from __future__ import annotations

from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser
from pathlib import Path
from timeit import default_timer as timer

from flacx_torch.utils import argparse_range

ACTION_DECODE = "decode"
ACTION_ENCODE = "encode"

DEFAULT_BLOCK_SIZE = 4608
DEFAULT_MAX_LPC_ORDER = 12
DEFAULT_QLP_COEFF_PRECISION = 5
DEFAULT_RICE_PARTITION_ORDER = "5"


def cmd_encode(path_in: Path, path_out: Path, block_size: int,
               max_lpc_order: int, qlp_coeffs_precision: int,
               rice_partition_order: range, batch_frames: int,
               stereo: str, oracle: bool,
               wasted_bits: bool = False,
               exact_order_search: bool = False,
               show_stats: bool = False, best: bool = False,
               escapes: bool = True,
               apodization: str = "tukey(0.5)",
               device: str = "cuda") -> None:
    from flacx_torch import pipeline
    from flacx_torch.wavio import read_wav, read_wav_chunks, wav_info

    windows = tuple(w for w in apodization.replace(";", ",").split(",")
                    if w.strip())
    sample_rate, bps, channels, total = wav_info(path_in)
    if sample_rate <= 48_000 and max_lpc_order > 12:
        raise SystemExit(
            "subset streams at <= 48 kHz require LPC order <= 12")

    time_start = timer()
    if best:
        if apodization == "tukey(0.5)":
            # --best defaults to the multi-window sweep unless -A is given
            windows = ("tukey(0.5)", "hann", "flattop")
        # the block-size sweep needs the whole file resident anyway
        *_, pcm = read_wav(path_in)
        with path_out.open("wb") as f:
            stats = pipeline.encode_best(
                f, pcm, sample_rate=sample_rate, bps=bps, channels=channels,
                max_lpc_order=max_lpc_order,
                qlp_precision=qlp_coeffs_precision,
                partition_orders=tuple(rice_partition_order),
                batch_frames=batch_frames, stereo=stereo,
                wasted_bits=wasted_bits, windows=windows, device=device)
        time_end = timer()
        delta = "{0:.6g}".format(time_end - time_start)
        print(f"Encoding completed in {delta} seconds")
        ratio = stats["bytes_out"] / max(stats["bytes_in"], 1)
        print(f"  {stats['bytes_in']} -> {stats['bytes_out']} bytes "
              f"(ratio {ratio:.3f}), best block size {stats['block_size']}")
        return
    # constant-memory path: the WAV streams through in batch-sized chunks
    # (O(batch_frames · block_size) peak, any file length)
    with path_out.open("wb") as f:
        stats = pipeline.encode_chunks_to_file(
            f, read_wav_chunks(path_in, batch_frames * block_size),
            sample_rate=sample_rate, bps=bps, channels=channels,
            block_size=block_size, max_lpc_order=max_lpc_order,
            qlp_precision=qlp_coeffs_precision,
            partition_orders=tuple(rice_partition_order),
            total_samples=total,
            batch_frames=batch_frames, stereo=stereo, device=device,
            oracle=oracle, wasted_bits=wasted_bits, escapes=escapes,
            order_search="exact" if exact_order_search else "estimate",
            collect_stats=show_stats, windows=windows)
    time_end = timer()

    delta = "{0:.6g}".format(time_end - time_start)
    print(f"Encoding completed in {delta} seconds")
    ratio = stats["bytes_out"] / max(stats["bytes_in"], 1)
    rt = stats["samples"] / sample_rate / max(time_end - time_start, 1e-9)
    print(f"  {stats['bytes_in']} -> {stats['bytes_out']} bytes "
          f"(ratio {ratio:.3f}), {rt:.1f}x realtime")
    if show_stats and "stats" in stats:
        import json
        print("  " + json.dumps(stats["stats"]))


def cmd_decode(path_in: Path, path_out: Path, oracle: bool = False,
               batch_frames: int = 256, stream: bool = False,
               device: str = "cuda") -> None:
    import hashlib

    from flacx_torch.wavio import pcm_to_le_bytes, write_wav

    if stream:
        # constant-memory path: O(readahead) regardless of file length
        from flacx_torch.decoder import decode_stream
        from flacx_torch.wavio import write_wav_chunks

        time_start = timer()
        with open(path_in, "rb") as f:
            streaminfo, chunks = decode_stream(f, oracle=oracle,
                                               batch_frames=batch_frames,
                                               device=device)
            md5 = hashlib.md5()

            def hashed():
                for pcm in chunks:
                    md5.update(pcm_to_le_bytes(pcm, streaminfo.sample_size))
                    yield pcm

            write_wav_chunks(path_out, streaminfo.sample_rate,
                             streaminfo.sample_size, streaminfo.channels,
                             hashed())
        time_end = timer()
        if streaminfo.md5 != bytes(16) and md5.digest() != streaminfo.md5:
            raise SystemExit("decoded audio MD5 mismatch")
    else:
        from flacx_torch.decoder import decode_array

        data = path_in.read_bytes()

        time_start = timer()
        streaminfo, pcm = decode_array(data, oracle=oracle,
                                       batch_frames=batch_frames,
                                       device=device)
        time_end = timer()

        if streaminfo.md5 != bytes(16):
            got = hashlib.md5(
                pcm_to_le_bytes(pcm, streaminfo.sample_size)).digest()
            if got != streaminfo.md5:
                raise SystemExit("decoded audio MD5 mismatch")

        write_wav(path_out, streaminfo.sample_rate, streaminfo.sample_size,
                  pcm)
    delta = "{0:.6g}".format(time_end - time_start)
    print(f"Decoding completed in {delta} seconds")


def cmd_encode_corpus(args) -> None:
    from flacx_torch.parallel.corpus import encode_corpus

    if isinstance(args.rice_partition_order, str):
        args.rice_partition_order = argparse_range(args.rice_partition_order)
    time_start = timer()
    result = encode_corpus(
        args.infiles, args.outdir, block_size=args.block_size,
        max_lpc_order=args.max_lpc_order,
        qlp_precision=args.qlp_coeff_precision,
        partition_orders=tuple(args.rice_partition_order),
        batch_frames=args.batch_frames, stereo=args.stereo,
        windows=tuple(w for w in args.apodization.replace(";", ",")
                      .split(",") if w.strip()),
        resume=args.resume, device=args.device)
    delta = timer() - time_start
    ratio = result.bytes_out / max(result.bytes_in, 1)
    skipped = (f", {len(result.skipped)} resumed"
               if result.skipped else "")
    print(f"Encoded {len(result.encoded)} files "
          f"({result.samples} samples) in {delta:.6g} seconds "
          f"(ratio {ratio:.3f}){skipped}")
    for path, err in result.failed.items():
        print(f"  FAILED {path}: {err}")


def make_argument_parser() -> ArgumentParser:
    parser = ArgumentParser(prog="flacx_torch",
                            formatter_class=ArgumentDefaultsHelpFormatter)

    action = parser.add_subparsers(title="action", dest="action",
                                   required=True)

    decode = action.add_parser(ACTION_DECODE,
                               formatter_class=ArgumentDefaultsHelpFormatter)
    decode.add_argument("infile", type=Path, metavar="infile.flac")
    decode.add_argument("outfile", type=Path, metavar="outfile.wav")
    decode.add_argument(
        "--no-device", action="store_true",
        help="Decode with the sequential host oracle instead of the "
             "batched pipeline.")
    decode.add_argument(
        "--batch-frames", type=int, default=256,
        help="Frames per device decode dispatch.", metavar="N")
    decode.add_argument(
        "--stream", action="store_true",
        help="Constant-memory streaming decode: read, decode and write "
             "in windows instead of loading the whole file.")
    decode.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="Torch device of the batched pipeline: the card, or the CPU "
             "(each kernel's plain PyTorch version).")

    encode = action.add_parser(ACTION_ENCODE,
                               formatter_class=ArgumentDefaultsHelpFormatter)
    encode.add_argument("infile", type=Path, metavar="infile.wav")
    encode.add_argument("outfile", type=Path, metavar="outfile.flac")

    encode.add_argument(
        "-b", "--block-size", type=int, default=DEFAULT_BLOCK_SIZE,
        help=("Blocksize in samples. "
              "For subset streams this must be <= 4608 if the samplerate <= "
              "48kHz. For  subset streams with higher samplerates it must be "
              "<= 16384."),
        metavar="N")
    encode.add_argument(
        "-l", "--max-lpc-order", type=int, default=DEFAULT_MAX_LPC_ORDER,
        help=("Specifies  the  maximum LPC order. This number must "
              "be <= 32. For subset streams, it must be <= 12 if the "
              "sample rate is <= 48kHz."),
        metavar="N")
    encode.add_argument(
        "-q", "--qlp-coeff-precision", type=int,
        default=DEFAULT_QLP_COEFF_PRECISION,
        help=("Precision of the quantized linear-predictor coefficients. "
              "(min is 5)"),
        metavar="N")
    encode.add_argument(
        "-r", "--rice-partition-order", type=argparse_range,
        default=DEFAULT_RICE_PARTITION_ORDER,
        help=("[min,]max residual partition order (0..15). min defaults to "
              "0 if unspecified."),
        metavar="[M,]N")

    # extensions beyond the reference surface
    encode.add_argument(
        "--batch-frames", type=int, default=256,
        help="Frames per device dispatch (larger batches amortize "
             "per-dispatch overhead).", metavar="N")
    encode.add_argument(
        "--stereo", choices=("auto", "independent"), default="auto",
        help="Stereo decorrelation policy (auto searches L/S, S/R, M/S).")
    encode.add_argument(
        "--no-device", action="store_true",
        help="Encode on the host oracle instead of the batched pipeline.")
    encode.add_argument(
        "--best", action="store_true",
        help="Best-compression sweep: try several block sizes with exact "
             "order search and keep the smallest (slower).")
    encode.add_argument(
        "--stats", action="store_true",
        help="Print per-run subframe/stereo-mode histograms.")
    encode.add_argument(
        "--no-escapes", action="store_true",
        help="Never emit escaped Rice partitions (raw two's-complement "
             "blocks; the reference decoder reads them but some strict "
             "subset tools may not expect them).")
    encode.add_argument(
        "--exact-order-search", action="store_true",
        help="Evaluate every LPC order's true integer residual instead of "
             "ranking by prediction error (best compression, slower).")
    encode.add_argument(
        "-A", "--apodization", default="tukey(0.5)", metavar="W[;W...]",
        help="LPC analysis apodization window(s), semicolon- or "
             "comma-separated (tukey(P), hann, rectangle, triangle, "
             "welch, blackman, nuttall, flattop, gauss(S)).  With "
             "several, the best window is chosen per frame/channel/"
             "order by predicted residual size (the reference hardcodes "
             "tukey(0.5)).  Ranking is exact under --exact-order-search; "
             "the default estimate ranking picks well but is heuristic.")
    encode.add_argument(
        "--wasted-bits", action="store_true",
        help="Strip shared trailing zero bits per subframe (spec-correct "
             "and smaller, but the reference decoder cannot read such "
             "streams due to its wasted-bits parsing bug).")
    encode.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="Torch device of the batched pipeline: the card, or the CPU "
             "(each kernel's plain PyTorch version).")

    corpus = action.add_parser(
        "encode-corpus", formatter_class=ArgumentDefaultsHelpFormatter,
        help="Batch-encode many WAV files with globally bucketed device "
             "dispatches.")
    corpus.add_argument("outdir", type=Path, metavar="outdir/")
    corpus.add_argument("infiles", type=Path, nargs="+",
                        metavar="infile.wav")
    corpus.add_argument("-b", "--block-size", type=int,
                        default=DEFAULT_BLOCK_SIZE, metavar="N")
    corpus.add_argument("-l", "--max-lpc-order", type=int,
                        default=DEFAULT_MAX_LPC_ORDER, metavar="N")
    corpus.add_argument("-q", "--qlp-coeff-precision", type=int,
                        default=DEFAULT_QLP_COEFF_PRECISION, metavar="N")
    corpus.add_argument("-r", "--rice-partition-order", type=argparse_range,
                        default=DEFAULT_RICE_PARTITION_ORDER,
                        metavar="[M,]N")
    corpus.add_argument("--batch-frames", type=int, default=512, metavar="N")
    corpus.add_argument("-A", "--apodization", default="tukey(0.5)",
                        metavar="W[;W...]",
                        help="LPC apodization window(s), as in encode -A.")
    corpus.add_argument("--stereo", choices=("auto", "independent"),
                        default="auto")
    corpus.add_argument(
        "--resume", action="store_true",
        help="Skip inputs already completed by a previous run into the "
             "same outdir (file-granular checkpoint manifest).")
    corpus.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="Torch device of the batched pipeline: the card, or the CPU "
             "(each kernel's plain PyTorch version).")
    return parser


def main(argv: list[str] | None = None) -> None:
    args = make_argument_parser().parse_args(argv)
    if args.action == ACTION_DECODE:
        cmd_decode(args.infile, args.outfile, args.no_device,
                   args.batch_frames, args.stream, args.device)
    if args.action == "encode-corpus":
        cmd_encode_corpus(args)
    if args.action == ACTION_ENCODE:
        if isinstance(args.rice_partition_order, str):
            args.rice_partition_order = argparse_range(
                args.rice_partition_order)
        cmd_encode(args.infile, args.outfile, args.block_size,
                   args.max_lpc_order, args.qlp_coeff_precision,
                   args.rice_partition_order, args.batch_frames,
                   args.stereo, args.no_device,
                   args.wasted_bits, args.exact_order_search, args.stats,
                   args.best, not args.no_escapes, args.apodization,
                   args.device)


if __name__ == "__main__":
    main()
