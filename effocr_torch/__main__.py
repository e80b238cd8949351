"""``python -m effocr_torch <command>``; the ported commands are ``infer``
and ``serve``."""

import sys


def main():
    cmds = {"infer": "effocr_torch.cli.infer",
            "serve": "effocr_torch.cli.serve"}
    if len(sys.argv) < 2 or sys.argv[1].replace("-", "_") not in cmds:
        print(f"usage: python -m effocr_torch {{{','.join(cmds)}}} ...; "
              "ROADMAP.md lists the commands still to port")
        sys.exit(1)
    mod = __import__(cmds[sys.argv.pop(1).replace("-", "_")],
                     fromlist=["main"])
    mod.main()


if __name__ == "__main__":
    main()
