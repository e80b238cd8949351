"""Convert the original EffOCR's artifacts into the layout both packages
read — ``python -m effocr_torch import-reference``.

``--recognizer_dir``: a reference-format dir (enc_best.pth timm state
dict, or enc_best.onnx, + FAISS ref.index + ref.txt) -> enc_best.msgpack,
model.json, ref.npz, ref.txt (default <recognizer_dir>/tpu_converted).
``infer`` also converts such a dir on first use; this command does it
explicitly, with ``--imsize`` and ``--arch``.  ``--localizer_pt``: an
ultralytics yolov5 ``best.pt`` (a state dict or the full module pickle)
-> best_bbox_mAP.msgpack + model.json in ``--out``.
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m effocr_torch import-reference",
                                description=__doc__)
    p.add_argument("--recognizer_dir", type=str, default=None,
                   help="reference-format dir (enc_best.pth + ref.index + "
                        "ref.txt)")
    p.add_argument("--localizer_pt", type=str, default=None,
                   help="ultralytics yolov5 checkpoint (.pt): a state dict "
                        "or the full module pickle")
    p.add_argument("--out", type=str, default=None,
                   help="output dir (default <recognizer_dir>/tpu_converted; "
                        "required with --localizer_pt)")
    p.add_argument("--arch", type=str, default=None,
                   help="registry arch override (auto-detected from the "
                        "state dict otherwise)")
    p.add_argument("--imsize", type=int, default=224,
                   help="encoder input size the checkpoint was trained at "
                        "(the reference's paired transform is 224)")
    p.add_argument("--input_size", type=int, default=640,
                   help="localizer canvas width (letterbox_engine default)")
    p.add_argument("--input_height", type=int, default=None)
    args = p.parse_args(argv)

    if args.recognizer_dir:
        from effocr_torch.interop.reference_artifacts import (
            import_reference_recognizer_dir,
        )

        out = import_reference_recognizer_dir(
            args.recognizer_dir, args.out, arch=args.arch,
            image_size=args.imsize,
        )
        print(f"recognizer converted -> {out}")
    if args.localizer_pt:
        if not args.out:
            raise SystemExit("--localizer_pt requires --out")
        from effocr_torch.interop.yolo_import import (
            import_ultralytics_localizer,
        )

        out = import_ultralytics_localizer(
            args.localizer_pt, args.out, input_size=args.input_size,
            input_height=args.input_height,
        )
        print(f"localizer converted -> {out}")
    if not args.recognizer_dir and not args.localizer_pt:
        raise SystemExit("pass --recognizer_dir and/or --localizer_pt")


if __name__ == "__main__":
    main()
