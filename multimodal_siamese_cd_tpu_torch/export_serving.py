"""Export a trained checkpoint to a self-contained serving bundle (the
JAX package's ``tools/export_serving.py`` on the port).

    python -m multimodal_siamese_cd_tpu_torch.export_serving -c siamese \\
        -p proj -o runs/ -d /data/sn7 --dest siamese_serving.zip \\
        [--epoch 100] [--buckets 256,512,1024] [--platforms cuda,cpu] \\
        [--weights fp32|bf16] [--batch-sizes 1,8] [--device cpu] [KEY VALUE ...]

Loads ``{out}/networks/{NAME}_checkpoint{epoch}.pt`` through
``checkpoints.load_checkpoint`` onto ``--device`` (default: the card) and
exports it for ``--platforms`` (default: that device's platform). See
:mod:`.serving` for the bundle.
"""

from __future__ import annotations

from . import checkpoints, experiment_manager, parsers, serving


def main(argv=None):
    """Export as the arguments say; prints one line and returns the
    bundle's path."""
    parser = parsers.training_argument_parser()
    parser.add_argument("--dest", required=True, help="output bundle path")
    parser.add_argument("--epoch", type=int, default=None,
                        help="checkpoint epoch (default INFERENCE_CHECKPOINT)")
    parser.add_argument("--buckets", default="256,512,1024",
                        help="comma-separated square bucket sizes")
    parser.add_argument("--platforms", default=None,
                        help="comma-separated export platforms (cuda, cpu)")
    parser.add_argument("--weights", default="fp32", choices=["fp32", "bf16"],
                        help="weight storage dtype (bf16 halves the bundle)")
    parser.add_argument("--batch-sizes", default="1",
                        help="comma-separated forward batch sizes, e.g. 1,8 "
                             "(predict_batch amortizes dispatch like eval's "
                             "group-of-8 batching)")
    args = parser.parse_args(argv)
    cfg = experiment_manager.setup_cfg(args)

    epoch = args.epoch if args.epoch is not None else cfg.INFERENCE_CHECKPOINT
    model, _, step = checkpoints.load_checkpoint(epoch, cfg, device=args.device)
    buckets = [(int(s), int(s)) for s in args.buckets.split(",")]
    platforms = args.platforms.split(",") if args.platforms else None
    batch_sizes = [int(b) for b in args.batch_sizes.split(",")]

    path = serving.export_serving_bundle(
        model, cfg, args.dest, buckets=buckets, platforms=platforms,
        weights_dtype=args.weights, batch_sizes=batch_sizes)
    print(f"exported step-{step} checkpoint to {path} "
          f"({path.stat().st_size / 1e6:.1f} MB, buckets={buckets}, "
          f"batch_sizes={batch_sizes}, weights={args.weights})")
    return path


if __name__ == "__main__":
    main()
