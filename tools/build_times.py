"""Wall seconds to build the port's six CUDA libraries, with the nvcc flags of
``ops/_cuda.py`` and with one flag dropped from them, in turns.

    python3 tools/build_times.py [FLAG]

FLAG defaults to ``--split-compile=0``. Each build runs in a fresh copy of
the port under ``build/build_times/`` (nothing cached), as ``chip_smoke.py``
builds: all six libraries at once. Prints one line a build: its variant, the
wall seconds and the seconds at which each library was done. Needs ``nvcc``.
"""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "socialmedia_textimage_classification_auxlosses_tpu_torch"


def main(argv):
    flag = argv[0] if argv else "--split-compile=0"
    for tag in ("with", "without", "without", "with"):
        d = os.path.join(ROOT, "build", "build_times", tag)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, PKG), os.path.join(d, PKG),
                        ignore=shutil.ignore_patterns("__pycache__"))
        if tag == "without":
            p = os.path.join(d, PKG, "ops", "_cuda.py")
            s = open(p).read()
            assert f', "{flag}")' in s, f"{flag} is not among the flags"
            open(p, "w").write(s.replace(f', "{flag}")', ")"))
        code = (f"import sys, time; sys.path.insert(0, {d!r}); from {PKG}.ops import _cuda; "
                f"t = time.time(); s = _cuda.build(); "
                f"print({tag!r}, round(time.time() - t, 1), "
                f"{{k: round(v, 1) for k, v in s.items()}})")
        r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
        print(r.stdout.strip() if r.returncode == 0 else r.stderr[-2000:], flush=True)
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
