"""The import guard: nothing the benchmark loads is JAX or the JAX package,
and the reference loads nothing of the port either. Top-level names are
compared whole: the port's name begins with the JAX package's."""

import json
import subprocess
import sys

from port_bench import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "pde_superresolution_tpu"}


def loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=cells.BENCH_DIR.parent, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_routes_and_metrics_load_no_jax():
    code = "\n".join([
        "from pathlib import Path",
        "import port_bench.run, port_bench.control, port_bench.trace, port_bench.compare",
        "from port_bench import cells",
        "for kind in ('routes', 'metrics'):",
        "    for p in sorted((cells.BENCH_DIR / kind).glob('*.py')):",
        "        cells.load_module(p)",
        "from pde_superresolution_torch.scripts import run_ensemble",
    ])
    names = loaded(code)
    assert "pde_superresolution_torch" in names and "port_bench" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    names = loaded("import port_bench.reference.model, port_bench.compare, "
                   "port_bench.inputs, port_bench.flops")
    assert "torch" in names
    assert not names & (FORBIDDEN | {"pde_superresolution_torch"})
