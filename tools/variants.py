"""Text-patched builds of the port's CUDA sources, swapped in under the
kernel wrappers, for timing variants of a kernel in turns in one process
(``tools/k3_variants.py``, ``tools/k12_variants.py``).

A variant is the tree's ``src/repro_torch/csrc`` with a few lines
replaced; ``build`` writes each variant's sources to
``build/<tool>/<name>/`` and compiles the requested sources there with
the port's nvcc flags, one nvcc per library, all at once.  ``use`` points
``kernels/decode_attention.py`` and ``kernels/paged_attention.py`` at one
build's libraries, so their wrappers (split plans, checks, counters)
launch that build's kernels.  A parent's csrc is timed against this
tree's by ``chip_smoke.py``'s compare phases (``--parent-source``,
``--parent-dense-source``), not here.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"


def build(out_root: Path, variants: dict, stems) -> dict:
    """{name: {stem: (declared entry points, ptxas log)}} of the tree
    ("tree") and every variant of ``variants`` ({name: [(file, a line of
    the tree's source, its replacement)]}); ``stems`` are the sources to
    build (``decode_attention``, ``paged_attention``).  A build that fails
    is reported and left out; a patch that does not match exactly one line
    of its file stops it."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import paged_attention as PA
    entries = {"decode_attention": (DA, list(DA._ENTRIES) + [DA._OCCUPANCY]),
               "paged_attention": (PA, list(PA.ENTRIES))}
    dirs = {}
    for name in ["tree", *variants]:
        out = out_root / name
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(CSRC, out,
                        ignore=shutil.ignore_patterns("*.so", "*.log"))
        for file, old, new in variants.get(name, ()):
            text = (out / file).read_text()
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} is not one line "
                                 f"of {file}")
            (out / file).write_text(text.replace(old, new))
        dirs[name] = out
    procs = {(name, stem): subprocess.Popen(
        [B._nvcc(), *B.NVCC_FLAGS, "-o", str(out / f"lib{stem}.so"),
         str(out / f"{stem}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, out in dirs.items() for stem in stems}
    built = {}
    for (name, stem), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}/{stem}: nvcc failed\n{log[-4000:]}", flush=True)
            built[name] = None
            continue
        if built.get(name, {}) is None:
            continue
        module, names = entries[stem]
        cdll = ctypes.CDLL(str(dirs[name] / f"lib{stem}.so"))
        fns = {n: module.declare(cdll, n) for n in names if hasattr(cdll, n)}
        built.setdefault(name, {})[stem] = (fns, log)
    return {name: b for name, b in built.items() if b is not None}


def use(builds: dict, name: str) -> None:
    """Point the wrappers at build ``name``'s libraries (each source not
    built there keeps the tree's own library)."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import paged_attention as PA
    for stem, module in (("decode_attention", DA), ("paged_attention", PA)):
        module._fns.clear()
        if stem in builds[name]:
            module._fns.update(builds[name][stem][0])


def reset() -> None:
    """Back to the tree's own libraries (built and loaded on first use)."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import paged_attention as PA
    DA._fns.clear()
    PA._fns.clear()
