"""The CUDA build's library hash (ops/_build.py): it covers the source, the
headers beside it and the flags, so an edited header never loads a stale
library. Needs no nvcc."""
from paddle_tpu_torch.ops import _build


def _tree(tmp_path):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint f() { return 1; }\n')
    (tmp_path / "h.cuh").write_text("#pragma once\n")
    (tmp_path / "other.cuh").write_text("// another header\n")
    return tmp_path / "k.cu"


def test_digest_is_stable(tmp_path):
    src = _tree(tmp_path)
    assert _build.source_digest(src) == _build.source_digest(src)
    (tmp_path / "notes.txt").write_text("not a source")
    assert _build.source_digest(src) == _build.source_digest(src)


def test_digest_follows_headers_source_and_flags(tmp_path):
    src = _tree(tmp_path)
    before = _build.source_digest(src)
    (tmp_path / "h.cuh").write_text("#pragma once\n// edited\n")
    after_header = _build.source_digest(src)
    assert after_header != before
    (tmp_path / "new.cuh").write_text("// a header added\n")
    assert _build.source_digest(src) != after_header
    (tmp_path / "new.cuh").unlink()
    assert _build.source_digest(src) == after_header
    src.write_text(src.read_text() + "// edited\n")
    assert _build.source_digest(src) != after_header
    assert (_build.source_digest(src, _build.NVCC_FLAGS + ("-G",))
            != _build.source_digest(src))


def test_repo_sources_hash_their_headers():
    """The flash kernels' source includes sm90.cuh, which the digest reads."""
    src = _build.CSRC / "flash_attention.cu"
    assert '#include "sm90.cuh"' in src.read_text()
    assert (_build.CSRC / "sm90.cuh").exists()
    assert len(_build.source_digest(src)) == 16
