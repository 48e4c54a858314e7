"""Compare each CUDA kernel's machine code (SASS) in this package's library
with another checkout's build of the same sources.

    python -m keras_nerf_tpu_torch.compare_builds --parent DIR

``DIR`` is the ``keras_nerf_tpu_torch/kernels/csrc`` directory of another
checkout (the parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists). Each of its ``.cu`` files is compiled alone
with this package's ``nvcc`` flags (``_build.build_single``), and every
kernel function of those libraries is compared, instruction by instruction
(``cuobjdump -sass``, addresses and constants masked), with the function of
the same name in this package's library: "identical", "differs" or
"missing" here. A change that leaves a kernel's SASS identical leaves its
code path, and its speed, as it was. Prints one line per kernel and the
whole as JSON. Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit), not a
card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

from keras_nerf_tpu_torch.kernels import _build


def sass(lib: Path) -> dict:
    """Kernel name (its anonymous namespace's hash removed) -> its
    instructions, branch targets and constants masked."""
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f_]+_", "", m.group(1))
            funcs[name] = []
        elif name is not None and "/*" in line:
            ins = re.sub(r"/\*[0-9a-f]{4}\*/", "", line.split(";")[0])
            funcs[name].append(re.sub(r"0x[0-9a-f]+", "X", ins.strip()))
    return funcs


def compare(parent: Path) -> dict:
    _build.load()
    mine = sass(_build.last_build().path)
    out = {}
    for src in sorted(parent.glob("*.cu")):
        out_dir = _build.BUILD_ROOT.parent / "compare_builds" / src.stem
        _build.build_single(src, out_dir, ())
        for name, body in sass(out_dir / f"lib{src.stem}.so").items():
            here = mine.get(name)
            out[f"{src.name}: {name}"] = {
                "instructions": len(body),
                "here": ("missing" if here is None else
                         "identical" if here == body else "differs")}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="kernels/csrc directory of another checkout")
    args = ap.parse_args(argv)
    res = compare(args.parent)
    for name, r in res.items():
        print(f"{name}: {r['instructions']} instructions, {r['here']}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
