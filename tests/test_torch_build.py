"""The port's kernel build and binding (determined_tpu_torch.ops._build),
on a machine without a card: what can be checked without nvcc."""
import pytest
import torch

from determined_tpu_torch.ops import _build


def test_nvcc_failure_is_a_named_error(tmp_path, monkeypatch):
    """A failed compile raises CudaKernelError with the compiler's log,
    and leaves no library behind to be loaded by mistake."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: refusing to compile' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    kernel = _build.CudaKernel("flash_fwd", "dtpu_flash_fwd", [])
    with pytest.raises(_build.CudaKernelError, match="refusing to compile"):
        kernel.launch()
    assert not kernel.library_path().exists()
    assert kernel.launches == 0


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    """Editing a kernel source (or the shared header) names a new
    library, so a stale build is never loaded."""
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    kernel = _build.CudaKernel("paged_attention", "dtpu_paged_attention", [])
    first = kernel.library_path()
    assert first == kernel.library_path()
    header = tmp_path / "attn_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert kernel.library_path() != first


@pytest.mark.parametrize("dtype,code", [
    (torch.float32, 0), (torch.bfloat16, 1), (torch.float16, None),
])
def test_dtype_codes(dtype, code):
    if code is None:
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            _build.dtype_code(dtype)
    else:
        assert _build.dtype_code(dtype) == code
