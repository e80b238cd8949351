"""``python -m effocr_torch <command>``.

Every command of the JAX package routes: ``infer``, ``serve``,
``train-recognizer``, ``train-localizer``, ``build-index``,
``build-freq-dict``, ``build-homoglyphs``, ``import-reference``,
``import-encoder``, ``export``, ``coco-split``, ``coco-combine``,
``coco-subset``, ``error-analysis``, ``viz``, ``train-seq2seq``,
``import-trocr``, ``make-corpus``, ``make-charset`` and
``format-dataset``.  ``NOT_PORTED`` (empty) would name the JAX
package's commands still to port (ROADMAP.md queue 1).

The JAX package's core/cache.py has no counterpart: it points JAX's
persistent compilation cache at a directory, and this package compiles
no XLA program.  Its one build step, the nvcc and g++ libraries, is
cached by kernels/cuda_build.py and native/ (rebuilt only when a source
is newer).
"""

import sys

COMMANDS = {
    "infer": "effocr_torch.cli.infer",
    "serve": "effocr_torch.cli.serve",
    "train_recognizer": "effocr_torch.cli.train_recognizer",
    "train_localizer": "effocr_torch.cli.train_localizer",
    "build_index": "effocr_torch.cli.build_index",
    "build_freq_dict": "effocr_torch.cli.build_freq_dict",
    "build_homoglyphs": "effocr_torch.cli.build_homoglyphs",
    "import_reference": "effocr_torch.cli.import_reference",
    "import_encoder": "effocr_torch.cli.import_encoder",
    "export": "effocr_torch.cli.export",
    "coco_split": "effocr_torch.cli.coco_tools",
    "coco_combine": "effocr_torch.cli.coco_tools",
    "coco_subset": "effocr_torch.cli.coco_tools",
    "error_analysis": "effocr_torch.cli.error_analysis",
    "viz": "effocr_torch.cli.viz",
    "train_seq2seq": "effocr_torch.cli.train_seq2seq",
    "import_trocr": "effocr_torch.cli.import_trocr",
    "make_corpus": "effocr_torch.cli.make_corpus",
    "make_charset": "effocr_torch.cli.make_charset",
    "format_dataset": "effocr_torch.cli.format_dataset",
}
NOT_PORTED: tuple = ()


def main():
    if len(sys.argv) < 2 or sys.argv[1].replace("-", "_") not in COMMANDS:
        names = ",".join(c.replace("_", "-") for c in COMMANDS)
        missing = (f"; not ported yet: {', '.join(NOT_PORTED)} (ROADMAP.md "
                   f"queue 1)" if NOT_PORTED else "")
        print(f"usage: python -m effocr_torch {{{names}}} ...{missing}")
        sys.exit(1)
    cmd = sys.argv.pop(1).replace("-", "_")
    mod = __import__(COMMANDS[cmd], fromlist=["main"])
    if cmd.startswith("coco_"):
        mod.main(cmd)
    else:
        mod.main()


if __name__ == "__main__":
    main()
