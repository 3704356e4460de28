"""Whether two trees of the port compile their kernels to the same machine
code, kernel by kernel.

    python3 tools/sass_ab.py OLD_ROOT NEW_ROOT [SOURCE ...]

Each ROOT is the root of a checkout (this one, or an older commit unpacked
with `git archive` into a directory that .gitignore lists). For each SOURCE
(a name under trafficbots_tpu_torch/csrc/, by default fused_attention and
attention_train; `name@DxF` builds a node kernel's source at d_model D and
d_ff F, `ops.node_encoder.build_defines`), both trees' .cu files are built
with the repo's nvcc flags (`ops.cuda_build.NVCC_FLAGS`, sm_90a) and
disassembled (`cuobjdump -sass`); each kernel (function) that both hold
is compared instruction for instruction (a kernel in an anonymous
namespace by its name without the namespace's per-file tag). Prints one
JSON line a source: the kernels that are the same, those that differ
(each with its first differing instruction), and those that only one tree
holds (a new instantiation shows there), with the card's name and power
limit; exits 1 if a kernel of both trees differs. Needs nvcc and cuobjdump (the machine with the card).
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from trafficbots_tpu_torch.ops import cuda_build  # noqa: E402
from trafficbots_tpu_torch.ops.node_encoder import build_defines  # noqa: E402


def build(root: Path, spec: str, out_dir: Path) -> tuple:
    """(the library's path, the nvcc process building root's csrc/<name>.cu
    into it), spec `name` or `name@DxF` (the node kernels' widths)."""
    name, _, widths = spec.partition("@")
    defines = build_defines(*map(int, widths.split("x"))) if widths else ()
    lib = out_dir / f"{abs(hash(str(root)))}-{spec}.so"
    src = root / "trafficbots_tpu_torch" / "csrc" / f"{name}.cu"
    return lib, subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *defines, "-o", str(lib), str(src)])


def kernels(lib: Path) -> dict:
    """function name -> its SASS instructions, of a built library."""
    tool = Path(cuda_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True, capture_output=True, text=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:  # the anonymous namespace's tag follows the file's contents: dropped
            fn = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", line.split("Function : ", 1)[1].strip())
            out[fn] = []
        elif fn is not None and (m := re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?);", line)):
            out[fn].append(m[1].strip())
    return out


def main() -> None:
    old, new = (Path(p).resolve() for p in sys.argv[1:3])
    names = sys.argv[3:] or ["fused_attention", "attention_train"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    differ = False
    with tempfile.TemporaryDirectory() as tmp:
        builds = {(root, name): build(root, name, Path(tmp)) for root in (old, new) for name in names}  # all at once
        for lib, proc in builds.values():
            if proc.wait() != 0:
                sys.exit(f"nvcc failed on {lib}")
        for name in names:
            a, b = kernels(builds[old, name][0]), kernels(builds[new, name][0])
            both = sorted(set(a) & set(b))
            diff = [f for f in both if a[f] != b[f]]
            differ |= bool(diff)
            first = {f: next([i, x, y] for i, (x, y) in enumerate(zip(a[f] + [""], b[f] + [""])) if x != y)
                     for f in diff}  # the first instruction that differs, and its index
            print(json.dumps({"source": name, "same": len(both) - len(diff), "differ": diff, "first_difference": first,
                              "only_old": sorted(set(a) - set(b)), "only_new": sorted(set(b) - set(a)),
                              "card": card}), flush=True)
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
