"""Import a pretrained HF encoder checkpoint for recognizer warm starts —
``python -m effocr_torch import-encoder``.

Converts an HF ConvNeXt (facebook/convnext-*) or ViT (google/vit-*)
checkpoint directory (config.json + model.safetensors or
pytorch_model.bin) into a Flax-format variables msgpack:

    python -m effocr_torch import-encoder --model_dir <hf_dir> --out enc_init.msgpack
    python -m effocr_torch train-recognizer ... --auto_model <printed arch> \\
        --checkpoint enc_init.msgpack
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m effocr_torch import-encoder",
                                description=__doc__)
    p.add_argument("--model_dir", required=True,
                   help="HF checkpoint dir (config.json + weights)")
    p.add_argument("--out", required=True,
                   help="output variables msgpack for --checkpoint")
    p.add_argument("--arch", default=None,
                   help="registry arch override (default: inferred from "
                        "config.json dims)")
    args = p.parse_args(argv)

    from effocr_torch.models.import_weights import import_hf_encoder
    from effocr_torch.train import checkpoint as ckpt

    variables, name, image_size = import_hf_encoder(args.model_dir,
                                                    arch=args.arch)
    ckpt.save_variables(variables, args.out)
    print(f"imported {name} (image_size {image_size}) -> {args.out}")
    print(f"warm start with: train-recognizer --auto_model {name} "
          f"--checkpoint {args.out} --finetune ...")


if __name__ == "__main__":
    main()
