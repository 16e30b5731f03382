"""The kernel libraries as built: no symbol of STB_GNU_UNIQUE binding, and
per kernel the ptxas figures of another checkout's build.

    python -m oscar_mpc_planner_mr_modification_tpu_torch.tools.build_check
    python -m oscar_mpc_planner_mr_modification_tpu_torch.tools.build_check \\
        --against DIR

Builds every library of ``qp_cuda.KERNELS`` (``qp_cuda.build_all``, the
build alone on the machine, timed: ``build_s`` and each source's
``nvcc_s``), then the section-counter variants of S1 (``-DS1_SECTIONS``)
and of the mirror linearize entry (``-DLIN_SECTIONS``), and lists each
library's dynamic symbols (``readelf --dyn-syms --wide``): a UNIQUE binding
is a fault, since the loader binds such a symbol across libraries even
under RTLD_LOCAL, so that two builds of one source in one process would
share it. With ``--against DIR`` (a checkout, such as ``git archive`` of
another commit unpacked under ``build/``) it then builds that checkout's
kernels with its own ``ops/qp_cuda.py`` in a second process, alone and
timed (``against_nvcc_s``), and compares, per kernel entry, registers and
cumulative stack bytes (``-Xptxas -v``; entries by demangled name, so that
nvcc's source-derived anonymous-namespace tag does not count). Prints one
JSON line; exits with code 1 on a UNIQUE symbol or a kernel whose figures
differ, 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import shutil
import subprocess
import sys
import time

from ..ops import qp_cuda
from . import common

#: The section-counter builds: library name -> macro.
VARIANTS = (("sqp_single", "S1_SECTIONS"),
            ("sqp_linearize_mirror", "LIN_SECTIONS"))

_OTHER = """
import json
from oscar_mpc_planner_mr_modification_tpu_torch.ops import qp_cuda
print(json.dumps({k: [v.log, v.seconds]
                  for k, v in qp_cuda.build_all().items()}))
"""


def unique_symbols(path) -> list:
    """The dynamic symbols of binding UNIQUE in the library at ``path``."""
    out = subprocess.run(["readelf", "--dyn-syms", "--wide", path],
                         capture_output=True, text=True, check=True).stdout
    return [line.split()[-1] for line in out.splitlines()
            if " UNIQUE " in line]


def demangled(entries: dict) -> dict:
    """``ptxas_entries`` keyed by demangled name (c++filt), the anonymous
    namespace's tag dropped."""
    names = list(entries)
    filt = shutil.which("c++filt") or shutil.which("cu++filt")
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names),
                             capture_output=True, text=True,
                             check=True).stdout.splitlines()
    else:
        out = [re.sub(r"_GLOBAL__N__\w+?_[0-9a-f]{8}", "", n) for n in names]
    return {k: entries[n] for k, n in zip(out, names)}


def run(against=None) -> dict:
    t = time.perf_counter()
    infos = qp_cuda.build_all()
    result = dict(card=common.card_line(), unique={}, ptxas={},
                  build_s=round(time.perf_counter() - t, 3),
                  nvcc_s={k: round(v.seconds, 3) for k, v in infos.items()})
    with concurrent.futures.ThreadPoolExecutor() as pool:  # side by side
        jobs = {f"{name} -D{macro}": pool.submit(
            qp_cuda.build_all, (name,), (macro,)) for name, macro in VARIANTS}
        variants = {key: job.result()[key.split()[0]]
                    for key, job in jobs.items()}
    for name, info in {**infos, **variants}.items():
        result["unique"][name] = unique_symbols(info.path)
    if against:
        other = subprocess.run([sys.executable, "-c", _OTHER],
                               cwd=os.path.abspath(against),
                               stdout=subprocess.PIPE, text=True, check=True)
        built = json.loads(other.stdout.strip().splitlines()[-1])
        logs = {k: v[0] for k, v in built.items()}
        result["against_nvcc_s"] = {k: round(v[1], 3)
                                    for k, v in built.items()}
        for name, info in infos.items():
            if name not in logs:
                continue
            if not info.log or not logs[name]:
                result["ptxas"][name] = "a build was reused: no report"
                continue
            mine = demangled(common.ptxas_entries(info.log))
            theirs = demangled(common.ptxas_entries(logs[name]))
            same = [k for k in theirs if mine.get(k) == theirs[k]]
            result["ptxas"][name] = dict(
                kernels=len(mine), theirs=len(theirs), equal=len(same),
                differ={k: (theirs[k], mine.get(k)) for k in theirs
                        if mine.get(k) != theirs[k]},
                new=sorted(k for k in mine if k not in theirs))
    return result


def main(argv=None) -> int:
    common.require_card("build_check")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None,
                    help="a checkout whose kernels to compare ptxas with")
    a = ap.parse_args(argv)
    result = run(a.against)
    print(json.dumps(result))
    bad = any(result["unique"].values()) or any(
        isinstance(v, dict) and v["differ"] for v in result["ptxas"].values())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
