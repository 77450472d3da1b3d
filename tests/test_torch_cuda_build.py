"""The kernel build's naming, on the CPU (no nvcc runs): a library is
named by the hash of its source and of every shared ``csrc/*.cuh``
header, so an edited header rebuilds every kernel."""
import shutil

from repro_torch import cuda_build


def test_library_path_covers_the_shared_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    assert sorted(p.name for p in csrc.glob("*.cuh")), "no shared header"
    names = [p.stem for p in csrc.glob("*.cu")]
    before = {n: cuda_build.library_path(n, csrc) for n in names}
    assert before == {n: cuda_build.library_path(n) for n in names}
    header = sorted(csrc.glob("*.cuh"))[0]
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build.library_path(n, csrc) for n in names}
    assert all(after[n] != before[n] for n in names)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(cuda_build.library_path(n, csrc) != after[n] for n in names)


def test_library_path_follows_its_own_source_only(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    before = cuda_build.library_path("ssd_scan", csrc)
    flash = csrc / "flash_attention.cu"
    flash.write_text(flash.read_text() + "\n// edited\n")
    assert cuda_build.library_path("ssd_scan", csrc) == before
    assert cuda_build.library_path("flash_attention", csrc) != (
        cuda_build.library_path("flash_attention"))
    assert before.name.startswith("libssd_scan-") and before.suffix == ".so"
