"""The port imports neither JAX nor the JAX package, directly or
indirectly: the GPU machine it runs on has no JAX."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import simka_tpu_torch, simka_tpu_torch.core.pipeline, "
        "simka_tpu_torch.cli, simka_tpu_torch.ops.countjoin, "
        "simka_tpu_torch.ops.compact, simka_tpu_torch.ops._kernels, "
        "simka_tpu_torch.ops.spectrum, simka_tpu_torch.core.checkpoint, "
        "simka_tpu_torch.core.sweep, simka_tpu_torch.core.budget, "
        "simka_tpu_torch.io.packed, simka_tpu_torch.io.native, "
        "simka_tpu_torch.profiling.probes, simka_tpu_torch.profiling.trace, "
        "simka_tpu_torch.minhash.cli, simka_tpu_torch.minhash.pipeline, "
        "simka_tpu_torch.minhash.sketch, simka_tpu_torch.minhash.device, "
        "simka_tpu_torch.minhash.bloom, simka_tpu_torch.minhash.murmur, "
        "simka_tpu_torch.minhash.sketch_file, "
        "simka_tpu_torch.minhash.distance, "
        "simka_tpu_torch.minhash.device_distance, "
        "simka_tpu_torch.parallel.sharded, "
        "simka_tpu_torch.parallel.multihost, "
        "simka_tpu_torch.viz.visualize\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'simka_tpu' "
        "or m.startswith('simka_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_port_builds_only_its_own_sources():
    """The native parser and the CUDA kernels compile from files inside
    simka_tpu_torch/, never from the JAX package's tree."""
    from simka_tpu_torch.io import native
    from simka_tpu_torch.ops import _kernels

    port = os.path.join(REPO, "simka_tpu_torch") + os.sep
    for path in (native.SRC, native.BUILD_DIR, _kernels.CSRC,
                 _kernels.BUILD_DIR, *_kernels.sources()):
        assert os.path.abspath(path).startswith(port), path
    assert os.path.exists(native.SRC)
    names = [os.path.basename(s) for s in _kernels.sources()]
    assert {"compact.cu", "kmers.cu", "minhash.cu", "min_distance.cu",
            "pair_sums.cu", "probes.cu", "runs.cu"} <= set(names)

