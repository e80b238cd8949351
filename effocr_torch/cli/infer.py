"""Inference CLI — ``python -m effocr_torch infer``.

Flag-compatible with the JAX package's ``infer`` command and reading the
same artifact directories: the localizer_dir holds ``model.json`` +
``best_bbox_mAP.msgpack``, the recognizer_dir ``model.json`` +
``enc_best.msgpack`` + ``ref.npz``/``ref.txt`` (or, for a recognizer
trained with a class head, ``num_classes`` in its model.json and a
``class_map.json``).  A recognizer_dir without ``ref.npz`` takes
``--build_index_from <char-folder tree>``: the renders of the tree are
embedded into an ad-hoc index, saved there.  A reference-format
recognizer_dir (the original EffOCR's enc_best.pth or enc_best.onnx +
FAISS ref.index + ref.txt) is converted on first use into
``<dir>/tpu_converted`` (interop/reference_artifacts.py), as the JAX
command does.  Adds ``--device`` (default
cuda).  ``--data_parallel`` runs one engine replica per visible CUDA
device (``EffOCRInference(devices=...)``), ``line_batch`` rounded up to
a multiple of their number as in the JAX command; with one device it
says so and runs unsharded.  ``--output_localizer_results DIR`` writes
each page with its boxes outlined (utils/viz.py ``draw_boxes``);
``--compare_ocr`` scores Tesseract (when its binary is present) and, with
credentials, Google Cloud Vision and Baidu on the same lines
(utils/comparators.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from glob import glob

import torch

from effocr_torch.cli.common import render_rows
from effocr_torch.core.config import (
    EncoderConfig,
    LocalizerConfig,
    PipelineConfig,
)
from effocr_torch.core.device import resolve_device
from effocr_torch.core.distributed import pad_batch_to_data_axis
from effocr_torch.data import image_io
from effocr_torch.data.folder import CharFolderDataset, embed_items
from effocr_torch.eval.textline import textline_evaluation
from effocr_torch.interop.flax_bridge import flax_to_state_dict
from effocr_torch.interop.flax_msgpack import read_variables
from effocr_torch.interop.reference_artifacts import (
    maybe_convert_reference_dir,
)
from effocr_torch.models.factory import (
    create_classifier,
    create_encoder,
    create_localizer,
)
from effocr_torch.pipelines.infer import EffOCRInference
from effocr_torch.retrieval.index import PrototypeIndex
from effocr_torch.utils.comparators import baidu_access_token, compare_ocr
from effocr_torch.utils.viz import draw_boxes


def _load_model(model, path: str):
    model.load_state_dict(flax_to_state_dict(read_variables(path)),
                          strict=True)
    return model


def load_recognizer(recognizer_dir: str):
    """(encoder, or classifier when model.json has ``num_classes``, with
    enc_best.msgpack's weights; model.json) of a recognizer dir."""
    with open(os.path.join(recognizer_dir, "model.json")) as f:
        meta = json.load(f)
    arch = meta.get("arch", "convnext_tiny")
    kw = dict(in_channels=meta.get("input_channels", 3),
              image_size=meta.get("image_size", 224))
    model = (create_classifier(arch, meta["num_classes"], **kw)
             if meta.get("num_classes") else create_encoder(arch, **kw))
    return _load_model(model, os.path.join(recognizer_dir,
                                           "enc_best.msgpack")), meta


def build_adhoc_index(encoder, tree: str, font_name, imsize: int,
                      channels: int, device) -> PrototypeIndex:
    """Prototype index from the renders of a char-folder tree (one font
    when ``font_name`` matches any, else every render), embedded by
    ``encoder`` under the plain transform (``folder.embed_items``)."""
    ds = CharFolderDataset(tree)
    ridx = render_rows(ds, font_name)
    embs = embed_items(encoder.to(device), ds, ridx, imsize, channels,
                       device)
    return PrototypeIndex(embs, [ds.char_for_path(ds.data[i][0])
                                 for i in ridx])


def load_engine(args) -> EffOCRInference:
    device = resolve_device(args.device)   # fail before loading any weights

    # localizer
    with open(os.path.join(args.localizer_dir, "model.json")) as f:
        loc_meta = json.load(f)
    loc_kw = {}
    if loc_meta.get("anchors"):   # fitted or imported anchor priors
        loc_kw["anchors"] = tuple(tuple(a) for a in loc_meta["anchors"])
    size = loc_meta.get("input_size", 640)
    loc_ch = loc_meta.get("input_channels", 3)
    localizer = _load_model(create_localizer(
        loc_meta.get("arch", "yolov5s"),
        num_classes=loc_meta.get("num_classes", 2), in_channels=loc_ch,
        **loc_kw,
    ), os.path.join(args.localizer_dir, "best_bbox_mAP.msgpack"))
    # a model trained on a rectangular canvas carries its height in
    # model.json; the flag still overrides
    if args.input_height is None:
        args.input_height = loc_meta.get("input_height")

    # recognizer: a reference-format dir (enc_best.pth or enc_best.onnx +
    # FAISS ref.index) is converted on first use
    args.recognizer_dir = maybe_convert_reference_dir(args.recognizer_dir)
    encoder, rec_meta = load_recognizer(args.recognizer_dir)
    imsize = rec_meta.get("image_size", 224)
    rec_ch = rec_meta.get("input_channels", 3)
    if rec_ch != loc_ch:
        raise ValueError(
            f"recognizer input_channels ({rec_ch}) != localizer "
            f"input_channels ({loc_ch}): the fused pipeline crops encoder "
            "inputs from the detector canvas, so both models must be "
            "trained with the same --input_channels")

    # classifier mode when the model has a class head and the dir holds
    # class_map.json (class index -> char); else the prototype index
    class_map = index = None
    cm_path = os.path.join(args.recognizer_dir, "class_map.json")
    if rec_meta.get("num_classes") and os.path.exists(cm_path):
        with open(cm_path) as f:
            class_map = {int(k): v for k, v in json.load(f).items()}
        print(f"{len(class_map)} classifier classes!")
    elif os.path.exists(os.path.join(args.recognizer_dir, "ref.npz")):
        index = PrototypeIndex.load(args.recognizer_dir)
        print(f"{len(index)} candidate chars!")
        if args.blacklist_chars:
            index.blacklist(args.blacklist_chars)
    elif args.build_index_from:
        # ad-hoc index from a render tree, saved into the recognizer dir
        index = build_adhoc_index(encoder, args.build_index_from,
                                  args.render_font_name, imsize, rec_ch,
                                  device)
        index.save(args.recognizer_dir)
        print(f"built ad-hoc index: {len(index)} candidate chars")
        if args.blacklist_chars:
            index.blacklist(args.blacklist_chars)
    else:
        raise FileNotFoundError(
            f"no ref.npz in {args.recognizer_dir}; pass --build_index_from "
            "<char-folder tree> to build an ad-hoc prototype index")

    # adaptive-height guard: clamp tiers to the heights the detector
    # trained on (model.json trained_heights)
    height_floor = height_cap = None
    if args.adaptive_height:
        trained = loc_meta.get("trained_heights")
        if trained:
            height_floor, height_cap = min(trained), max(trained)
        else:
            print("WARNING: --adaptive_height with a localizer_dir that "
                  "does not record trained_heights; tiers below the "
                  "training height cost CER. Retrain or pin --input_height.")

    cfg = PipelineConfig(
        lang=args.lang,
        vertical=args.vertical,
        localizer=LocalizerConfig(
            arch=loc_meta.get("arch", "yolov5s"),
            input_size=size,
            input_height=args.input_height,
            num_classes=loc_meta.get("num_classes", 2),
            input_channels=loc_ch,
            conf_thresh=args.localizer_conf_thresh,
            iou_thresh=args.localizer_iou_thresh,
            max_nms=args.max_nms,
            max_det=args.max_det,
        ),
        encoder=EncoderConfig(arch=rec_meta.get("arch", "convnext_tiny"),
                              image_size=imsize, input_channels=rec_ch),
        input_channels=loc_ch,
        adaptive_height_floor=height_floor,
        adaptive_height_cap=height_cap,
        anchor_margin=args.anchor_margin,
        anchor_multiplier=args.anchor_multiplier,
        spell_check=args.spell_check,
        spell_check_dict=args.dictionary_path,
        homoglyphs_path=args.homoglyphs,
        crop_source=args.crop_source,
        crop_geometry=(
            rec_meta.get("crop_geometry", "line")
            if args.crop_geometry == "auto" else args.crop_geometry
        ),
        retrieval_kernel=args.retrieval_kernel,
        nms_kernel=args.nms_kernel,
        transfer_bits=args.transfer_bits,
        out_quant=args.out_quant,
        compute_dtype=args.compute_dtype,
        line_batch=args.line_batch,
        crop_batch=args.crop_batch,
        encoder_sub_batch=args.encoder_sub_batch,
        prefetch_chunks=args.prefetch_chunks,
        adaptive_height=args.adaptive_height,
        adaptive_height_mode=args.adaptive_height_mode,
        adaptive_width=args.adaptive_width,
        chunk_sort=args.chunk_sort,
        crop_window=args.crop_window,
        box_pad=args.box_pad,
        tile_min_content_h=args.tile_min_h,
        max_words_per_line=args.max_words,
    )
    devices = None
    if getattr(args, "data_parallel", False):
        visible = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if device.type == "cuda" else [device])
        if len(visible) > 1:
            devices = visible
            cfg = dataclasses.replace(cfg, line_batch=pad_batch_to_data_axis(
                cfg.line_batch, len(devices)))
            print(f"data-parallel inference over {len(devices)} devices")
        else:
            print("--data_parallel: single device visible; running "
                  "unsharded")
    return EffOCRInference(cfg, localizer, encoder, index,
                           device=args.device, class_map=class_map,
                           devices=devices)


def add_engine_args(p: argparse.ArgumentParser) -> None:
    """Flags consumed by load_engine, shared by ``infer`` and ``serve``:
    the JAX package's flag surface plus --device."""
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda unless cpu is asked for")
    p.add_argument("--recognizer_dir", type=str, required=True)
    p.add_argument("--lang", type=str, required=True, choices=["en", "jp"])
    p.add_argument("--vertical", action="store_true", default=False)
    p.add_argument("--blacklist_chars", type=str, default=None)
    p.add_argument("--spell_check", action="store_true", default=False)
    p.add_argument("--dictionary_path", type=str, default=None)
    p.add_argument("--homoglyphs", type=str, default=None)
    p.add_argument("--localizer_dir", type=str, required=True)
    p.add_argument("--localizer_iou_thresh", type=float, default=0.01)
    p.add_argument("--localizer_conf_thresh", type=float, default=0.35)
    p.add_argument("--anchor_margin", type=float, default=None)
    p.add_argument("--anchor_multiplier", type=float, default=4.0)
    p.add_argument("--box_pad", type=float, default=0.0,
                   help="expand char boxes by this many canvas px along "
                        "the reading axis before cropping")
    p.add_argument("--tile_min_h", type=int, default=0)
    p.add_argument("--crop_source", type=str, default="letterbox",
                   choices=["letterbox", "original"])
    p.add_argument("--crop_geometry", type=str, default="auto",
                   choices=["auto", "tight", "line"],
                   help="crop rect extent on the non-reading axis; 'auto' "
                        "reads the recognizer model.json crop_geometry")
    p.add_argument("--crop_window", type=int, default=256,
                   help="static ROI slice size; must cover the max crop "
                        "side in canvas px")
    p.add_argument("--line_batch", type=int, default=16)
    p.add_argument("--crop_batch", type=int, default=512)
    p.add_argument("--max_nms", type=int, default=1024,
                   help="NMS candidate cap per line")
    p.add_argument("--max_words", type=int, default=64,
                   help="per-line word-box slots in the packed output")
    p.add_argument("--max_det", type=int, default=1000,
                   help="kept detections per line after NMS")
    p.add_argument("--encoder_sub_batch", type=int, default=None,
                   help="crop + encode crop_batch slots in sub-batches of "
                        "this size (bounds device memory)")
    p.add_argument("--prefetch_chunks", type=int, default=3,
                   help="host prep/dispatch pipeline depth")
    p.add_argument("--data_parallel", action="store_true", default=False)
    p.add_argument("--adaptive_height", action="store_true", default=False)
    p.add_argument("--adaptive_height_mode", type=str, default="fill",
                   choices=["fill", "native"])
    p.add_argument("--adaptive_width", action="store_true", default=False)
    p.add_argument("--chunk_sort", type=str, default="none",
                   choices=["none", "width"])
    p.add_argument("--transfer_bits", type=int, default=8,
                   choices=[2, 4, 8])
    p.add_argument("--compute_dtype", type=str, default="f32",
                   choices=["f32", "bf16"])
    p.add_argument("--out_quant", type=str, default="i32",
                   choices=["i32", "u16"])
    p.add_argument("--retrieval_kernel", type=str, default="xla",
                   choices=["xla", "pallas"],
                   help="pallas (the TPU name) = the hand-written fused "
                        "top-1 retrieval kernel; xla = torch matmul + "
                        "top-k")
    p.add_argument("--nms_kernel", type=str, default="xla",
                   choices=["xla", "pallas", "cuda"],
                   help="cuda (or pallas, its TPU name) = the hand-written "
                        "greedy-NMS keep-mask kernel; xla = plain torch ops")
    p.add_argument("--build_index_from", type=str, default=None)
    p.add_argument("--render_font_name", type=str, default=None)
    p.add_argument("--input_height", type=int, default=None,
                   help="rectangular letterbox bucket height (stride-32 "
                        "multiple); default from model.json, else square")


def write_overlays(out_dir: str, results, inference_coco) -> None:
    """One PNG a page under ``out_dir`` (its file name): the page in RGB
    with each detected box of ``inference_coco`` outlined in red."""
    os.makedirs(out_dir, exist_ok=True)
    annos_by_img = {}
    for a in inference_coco["annotations"]:
        annos_by_img.setdefault(a["image_id"], []).append(a)
    paths = {}
    for k in results:
        paths.setdefault(os.path.basename(str(k)), k)
    for im_entry in inference_coco["images"]:
        path = paths.get(im_entry["file_name"])
        if not isinstance(path, str):
            continue
        boxes = [
            [a["bbox"][0], a["bbox"][1],
             a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]]
            for a in annos_by_img.get(im_entry["id"], [])
        ]
        draw_boxes(image_io.read_rgb(path), boxes,
                   os.path.join(out_dir, im_entry["file_name"]))


def compare_external(args, coco) -> None:
    """Tesseract / GCV / Baidu on the COCO file's pages (Pillow's L
    conversion): each comparator's textline accuracy and CER printed."""
    baidu_token = None
    if args.baidu_api_key and args.baidu_secret_key:
        baidu_token = baidu_access_token(args.baidu_api_key,
                                         args.baidu_secret_key)
    imgs, gts = [], []
    for x in coco["images"]:
        imgs.append(image_io.read_l(os.path.join(args.image_dir,
                                                x["file_name"])))
        gts.append(x["text"])
    comp = compare_ocr(imgs, gts, lang="jpn" if args.lang == "jp" else "eng",
                       gcv_api_key=args.gcv_api_key,
                       baidu_access_token=baidu_token)
    for name, (c_acc, c_cer) in comp.items():
        print(f"{name} | Textline accuracy = {c_acc} | CER = {c_cer}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m effocr_torch infer")
    add_engine_args(p)
    p.add_argument("--image_dir", type=str, required=True)
    p.add_argument("--coco_json", type=str)
    p.add_argument("--no_spaces_eval", action="store_true", default=False)
    p.add_argument("--norm_edit", action="store_true", default=False)
    p.add_argument("--infer_over_img_dir", action="store_true", default=False)
    p.add_argument("--save_output", type=str, default=None)
    p.add_argument("--uncased", action="store_true", default=False)
    p.add_argument("--n_repeats", type=int, default=1)
    p.add_argument("--profile_stages", action="store_true", default=False,
                   help="print the per-stage host wall-clock split")
    p.add_argument("--output_localizer_results", type=str, default=None,
                   help="directory for detection-overlay images")
    p.add_argument("--compare_ocr", action="store_true", default=False,
                   help="also evaluate external comparators on the same "
                        "lines: Tesseract when installed; GCV/Baidu when "
                        "credentials are given")
    p.add_argument("--gcv_api_key", type=str,
                   default=os.environ.get("GCV_API_KEY"),
                   help="Google Cloud Vision API key (or $GCV_API_KEY); "
                        "enables the GCV comparator")
    p.add_argument("--baidu_api_key", type=str,
                   default=os.environ.get("BAIDU_API_KEY"))
    p.add_argument("--baidu_secret_key", type=str,
                   default=os.environ.get("BAIDU_SECRET_KEY"),
                   help="Baidu OCR credentials (or $BAIDU_API_KEY/"
                        "$BAIDU_SECRET_KEY); enables the Baidu comparator")
    args = p.parse_args(argv)

    if args.infer_over_img_dir:
        coco = None
        # .png and .jpg, sorted as one list, as the JAX command globs them
        images = sorted(
            glob(os.path.join(args.image_dir, "**/*.png"), recursive=True)
            + glob(os.path.join(args.image_dir, "**/*.jpg"), recursive=True))
    else:
        with open(args.coco_json) as f:
            coco = json.load(f)
        images = [os.path.join(args.image_dir, x["file_name"])
                  for x in coco["images"]]
    images = [c for c in images for _ in range(args.n_repeats)]
    engine = load_engine(args)

    if args.n_repeats > 1:
        # timing run: warm the kernels and caches outside the timed region
        engine.run(images[: engine.config.line_batch])
        engine.timer.reset()

    start = time.time()
    results, inference_coco = engine.run(images, return_coco=True)
    elapsed = time.time() - start
    print(f"Total time: {elapsed:.2f}s")
    print(f"Average time per image: {elapsed / max(len(images), 1):.4f}s")
    if args.profile_stages:
        print("Stage wall-clock split (prep/* = prefetch worker thread, "
              "main/* = consumer thread):")
        print(engine.timer.report())

    if args.save_output:
        os.makedirs(args.save_output, exist_ok=True)
        with open(os.path.join(args.save_output,
                               "inference_results.json"), "w") as f:
            json.dump({os.path.basename(str(k)): v
                       for k, v in results.items()}, f, indent=2,
                      ensure_ascii=False)
        with open(os.path.join(args.save_output,
                               "inference_coco.json"), "w") as f:
            json.dump(inference_coco, f, indent=2, ensure_ascii=False)

    if args.output_localizer_results:
        write_overlays(args.output_localizer_results, results,
                       inference_coco)

    if coco is not None:
        by_name = {os.path.basename(str(k)): v for k, v in results.items()}
        pairs = [(x["text"], by_name.get(x["file_name"]) or "")
                 for x in coco["images"]]
        acc, cer = textline_evaluation(
            pairs, print_incorrect=True,
            no_spaces_in_eval=args.no_spaces_eval,
            norm_edit_distance=args.norm_edit, uncased=args.uncased,
        )
        print(f"EffOCR | Textline accuracy = {acc} | CER = {cer}")
        if args.save_output:
            with open(os.path.join(args.save_output, "metrics.json"),
                      "w") as f:
                json.dump({
                    "n_lines": len(images),
                    "elapsed_s": round(elapsed, 3),
                    "lines_per_sec": round(
                        len(images) / max(elapsed, 1e-9), 2),
                    "textline_accuracy": acc,
                    "cer": cer,
                    "device": str(engine.device),
                }, f, indent=2)
        if args.compare_ocr:
            compare_external(args, coco)


if __name__ == "__main__":
    main()
