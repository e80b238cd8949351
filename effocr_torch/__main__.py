"""``python -m effocr_torch <command>``; the ported commands are
``infer``, ``serve``, ``train-recognizer``, ``train-localizer``,
``build-index`` and ``build-freq-dict``."""

import sys


def main():
    cmds = {"infer": "effocr_torch.cli.infer",
            "serve": "effocr_torch.cli.serve",
            "train_recognizer": "effocr_torch.cli.train_recognizer",
            "train_localizer": "effocr_torch.cli.train_localizer",
            "build_index": "effocr_torch.cli.build_index",
            "build_freq_dict": "effocr_torch.cli.build_freq_dict"}
    if len(sys.argv) < 2 or sys.argv[1].replace("-", "_") not in cmds:
        names = ",".join(c.replace("_", "-") for c in cmds)
        print(f"usage: python -m effocr_torch {{{names}}} ...; "
              "ROADMAP.md lists the commands still to port")
        sys.exit(1)
    mod = __import__(cmds[sys.argv.pop(1).replace("-", "_")],
                     fromlist=["main"])
    mod.main()


if __name__ == "__main__":
    main()
