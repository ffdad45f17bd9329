#!/usr/bin/env python3
"""Compare the machine code of the kernels in two checkouts.

    python3 tools/ptxas_ab.py DIR_A DIR_B

Run from the root of a checkout of the port (it reads the library list
of this checkout's chip_smoke.py): compiles DIR_A's and DIR_B's
ltjax_torch/kernels/csrc/*.cu in every variant that chip_smoke.py builds
and both trees have the source of (variants with a macro in NEW_MACROS
are skipped: an older tree ignores it), with the flags of
ltjax_torch/kernels/build.py (a cubin in place of the shared library;
all nvcc processes started together), and prints one JSON line: per
library each tree's ptxas report (registers, stack, spills), the
sha256 of its SASS (cuobjdump -sass) and of the SASS without the
kernel's mangled name (``code``: the instructions alone), and whether
each is equal; where the code differs, how much: each tree's instruction
count, and the instructions (and the opcodes alone, registers and
operands dropped) that one tree has and the other lacks, counted as
multisets (order ignored).  Needs
the CUDA toolkit (nvcc, cuobjdump).
"""

import collections
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from ltjax_torch.kernels import build  # noqa: E402

CSRC = os.path.join("ltjax_torch", "kernels", "csrc")
NEW_MACROS = set()


def _flags():
    out, skip = [], False
    for f in build.FLAGS:
        if skip:
            skip = False
            continue
        if f == "-Xcompiler":            # -Xcompiler -fPIC
            skip = True
            continue
        if f != "-shared":
            out.append(f)
    return out + ["-cubin"]


def main(dir_a: str, dir_b: str) -> None:
    nvcc = build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    targets = [(name, v) for name, v in cs.kernel_targets()
               if not set(v or {}) & NEW_MACROS
               and all(os.path.exists(os.path.join(root, CSRC, name + ".cu"))
                       for root in (dir_a, dir_b))]
    tmp = tempfile.mkdtemp(prefix="ptxas_ab_")
    jobs = {}
    for label, root in (("a", dir_a), ("b", dir_b)):
        for name, v in targets:
            key = (build.tag(name, v), label)
            cubin = os.path.join(tmp, f"{key[0]}-{label}.cubin")
            defs = [f"-D{k}={x}" for k, x in sorted((v or {}).items())]
            jobs[key] = (cubin, subprocess.Popen(
                [nvcc, *_flags(), *defs, "-o", cubin,
                 os.path.join(root, CSRC, name + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    res = {}
    for (tag, label), (cubin, proc) in jobs.items():
        _, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {tag} ({label}):\n{err}")
        ptxas = [re.sub(r"\s+", " ", ln.split(":", 1)[-1]).strip()
                 for ln in err.splitlines()
                 if "registers" in ln or "spill" in ln]
        sass = subprocess.run([cuobjdump, "-sass", cubin],
                              capture_output=True, text=True, timeout=300)
        # the SASS of the kernel alone: drop the file header lines
        body = "\n".join(ln for ln in sass.stdout.splitlines()
                         if not ln.startswith(("Fatbin", "=====", "arch",
                                               "code version", "host",
                                               "compile_size", "producer",
                                               "identifier")))
        # and without the kernel's mangled name, which spells out its
        # parameter list (a parameter added at the end renames it)
        code = "\n".join(ln for ln in body.splitlines()
                         if "Function :" not in ln)
        # the instructions: "/*0040*/  IMAD R1, ... ;  /* 0x... */"
        instr = [m.group(1).strip() for m in
                 (re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", ln)
                  for ln in code.splitlines()) if m]
        res.setdefault(tag, {})[label] = {
            "ptxas": ptxas,
            "sass_sha256": (hashlib.sha256(body.encode()).hexdigest()
                            if sass.returncode == 0 else None),
            "code_sha256": (hashlib.sha256(code.encode()).hexdigest()
                            if sass.returncode == 0 else None),
            "_instr": instr}
    for tag, r in res.items():
        ia, ib = r["a"].pop("_instr"), r["b"].pop("_instr")
        r["instructions"] = [len(ia), len(ib)]
        for key, f in (("instr_diff", lambda v: v),
                       ("opcode_diff", lambda v: v.split()[0] if v else v)):
            ca = collections.Counter(map(f, ia))
            cb = collections.Counter(map(f, ib))
            r[key] = [sum((ca - cb).values()), sum((cb - ca).values())]
        r["ptxas_equal"] = r["a"]["ptxas"] == r["b"]["ptxas"]
        r["sass_equal"] = (r["a"]["sass_sha256"] is not None
                           and r["a"]["sass_sha256"] == r["b"]["sass_sha256"])
        r["code_equal"] = (r["a"]["code_sha256"] is not None
                           and r["a"]["code_sha256"] == r["b"]["code_sha256"])
    print(json.dumps({"variants": len(res),
                      "all_ptxas_equal": all(r["ptxas_equal"]
                                             for r in res.values()),
                      "all_sass_equal": all(r["sass_equal"]
                                            for r in res.values()),
                      "all_code_equal": all(r["code_equal"]
                                            for r in res.values()),
                      "per_variant": res}))


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    main(sys.argv[1], sys.argv[2])
