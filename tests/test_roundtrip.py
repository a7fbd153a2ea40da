"""End-to-end byte-identity round-trip — the north star (SURVEY §7 step 4)."""

import numpy as np
import pytest

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.pipeline.compress import compress_bytes
from phyngsc_tpu.pipeline.decompress import decompress_bytes
from phyngsc_tpu.utils.fastq import synthesize_fastq

CFG = CodecConfig(
    subblock_input_bytes=64 << 10,  # small sub-blocks to exercise batching
    records_per_substream=16,
)


def check(data: bytes, n_writers: int = 1, cfg: CodecConfig = CFG):
    comp = compress_bytes(data, cfg, n_writers)
    back = decompress_bytes(comp)
    assert back == data
    return comp


def test_err_style_single_writer():
    data = synthesize_fastq(2000, read_len=36, seed=1)
    comp = check(data)
    assert len(comp) < len(data)  # actually compresses


def test_err_style_multi_writer():
    data = synthesize_fastq(3000, read_len=36, seed=2)
    check(data, n_writers=4)


def test_srr_style_76bp():
    data = synthesize_fastq(800, read_len=76, style="SRR", seed=3)
    check(data)


def test_variable_length_records():
    data = synthesize_fastq(1500, read_len=40, seed=4, variable_length=True)
    check(data, n_writers=2)


def test_heavy_ambiguity():
    data = synthesize_fastq(500, read_len=36, seed=5, ambiguity_rate=0.2)
    check(data)


def test_multiple_subblocks_per_writer():
    cfg = CodecConfig(subblock_input_bytes=8 << 10, records_per_substream=16)
    data = synthesize_fastq(1000, read_len=36, seed=6)
    comp = check(data, n_writers=2, cfg=cfg)


def test_block_splitting():
    # tiny blocks force sub-block splits across block boundaries
    cfg = CodecConfig(block_size=1 << 16, subblock_input_bytes=64 << 10,
                      records_per_substream=16)
    data = synthesize_fastq(2000, read_len=36, seed=7)
    check(data, n_writers=2, cfg=cfg)


def test_single_record_file():
    data = synthesize_fastq(1, read_len=36, seed=8)
    check(data)


def test_more_writers_than_records():
    data = synthesize_fastq(3, read_len=36, seed=9)
    check(data, n_writers=8)


def test_solid_delta_roundtrip():
    rng = np.random.default_rng(10)
    recs = []
    for i in range(200):
        colors = (rng.integers(0, 4, size=35) + ord("0")).astype(np.uint8).tobytes()
        qual = bytes(rng.integers(33, 64, size=36).astype(np.uint8))
        recs.append(b"@SOLID." + str(i).encode() + b"\nT" + colors + b"\n+\n" + qual + b"\n")
    data = b"".join(recs)
    check(data)


def test_mesh_sharded_encode_roundtrip():
    """Multi-chip path: encoders sharded over a 4-device data mesh produce a
    container that the (shard-agnostic) decoder round-trips byte-exactly."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    cfg = CodecConfig(subblock_input_bytes=64 << 10,
                      records_per_substream=16, data_shards=4)
    data = synthesize_fastq(1200, read_len=36, seed=21)
    comp = compress_bytes(data, cfg, 2)
    back = decompress_bytes(comp)
    assert back == data


def test_mesh_sharded_decode_roundtrip(monkeypatch):
    """Multi-device decode: the walk decode sharded over a 4-device data
    mesh — per-shard word rows, shard-local quality-before-DNA — round-trips
    byte-exactly, and the mesh path is asserted to actually engage (no
    silent single-device fallback)."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    monkeypatch.setenv("PHYNGSC_WALK", "kernel")
    from phyngsc_tpu.parallel import mesh as meshmod

    calls = []
    orig = meshmod.ShardedSubblockCodec.decode_walk

    def spy(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(meshmod.ShardedSubblockCodec, "decode_walk", spy)
    cfg = CodecConfig(subblock_input_bytes=1 << 30,
                      records_per_substream=16, data_shards=4)
    data = synthesize_fastq(1200, read_len=36, seed=27, ambiguity_rate=0.01)
    comp = compress_bytes(data, CodecConfig(subblock_input_bytes=1 << 30,
                                            records_per_substream=16), 1)
    back = decompress_bytes(comp, cfg)
    assert back == data
    assert calls, "sharded decode did not engage"


def test_mesh_sharded_decode_variable_lengths(monkeypatch):
    """Sharded decode with variable-length records (the slot walk inside
    shard_map) round-trips and engages the mesh path."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    monkeypatch.setenv("PHYNGSC_WALK", "kernel")
    import numpy as np

    from phyngsc_tpu.parallel import mesh as meshmod

    calls = []
    orig = meshmod.ShardedSubblockCodec.decode_walk

    def spy(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(meshmod.ShardedSubblockCodec, "decode_walk", spy)
    rng = np.random.default_rng(31)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(900):
        n = int(rng.integers(18, 44))
        seq = acgt[rng.integers(0, 4, size=n)]
        qual = rng.integers(33, 70, size=n).astype(np.uint8)
        recs.append(b"@vm%d\n" % i + seq.tobytes() + b"\n+\n"
                    + qual.tobytes() + b"\n")
    data = b"".join(recs)
    comp = compress_bytes(data, CodecConfig(subblock_input_bytes=1 << 30,
                                            records_per_substream=16), 1)
    back = decompress_bytes(comp, CodecConfig(records_per_substream=16,
                                              data_shards=4))
    assert back == data
    assert calls, "sharded decode did not engage"


def test_mesh_sharded_decode_shapes_bucketed(monkeypatch):
    """Sharded decode of many sub-blocks: the per-shard word rows are
    bucketed, so the compiled decoder is reused — not rebuilt for every
    sub-block's exact word count."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from phyngsc_tpu.parallel import mesh as meshmod

    shapes = []
    orig = meshmod.ShardedSubblockCodec.decode_walk

    def spy(self, words, *a, **kw):
        shapes.append(words.shape)
        return orig(self, words, *a, **kw)

    monkeypatch.setattr(meshmod.ShardedSubblockCodec, "decode_walk", spy)
    data = synthesize_fastq(6000, read_len=36, seed=29, ambiguity_rate=0.01)
    enc = CodecConfig(subblock_input_bytes=96 << 10, records_per_substream=16)
    comp = compress_bytes(data, enc, 1)
    back = decompress_bytes(comp, CodecConfig(records_per_substream=16,
                                              data_shards=4))
    assert back == data
    assert len(shapes) >= 6
    assert len(set(shapes)) <= 2, shapes


def test_mesh_sharded_decode_fallback_roundtrip(monkeypatch, caplog):
    """Misaligned substream geometry: with G=24 the bucketed record count
    gives S=86 substreams — not divisible across 4 shards — so can_decode
    is False and decode MUST fall back to the single-device walk, still
    round-tripping byte-exactly and logging the fallback as a warning."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    monkeypatch.setenv("PHYNGSC_WALK", "kernel")
    import logging as pylogging

    from phyngsc_tpu.parallel import mesh as meshmod

    mesh_calls = []
    orig = meshmod.ShardedSubblockCodec.decode_walk

    def spy(self, *a, **kw):
        mesh_calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(meshmod.ShardedSubblockCodec, "decode_walk", spy)
    cfg = CodecConfig(subblock_input_bytes=1 << 30,
                      records_per_substream=24, data_shards=4)
    codec = meshmod.ShardedSubblockCodec(
        meshmod.make_mesh(4, 1), cfg)
    from phyngsc_tpu.utils.shapes import bucket_records
    Rp = bucket_records(1200, 24)
    assert not codec.can_decode(Rp // 24, Rp, 24), \
        "geometry unexpectedly aligned — pick a different G"
    data = synthesize_fastq(1200, read_len=36, seed=27, ambiguity_rate=0.01)
    comp = compress_bytes(data, CodecConfig(subblock_input_bytes=1 << 30,
                                            records_per_substream=24), 1)
    with caplog.at_level(pylogging.DEBUG, logger="phyngsc_tpu"):
        back = decompress_bytes(comp, cfg)
    assert back == data
    assert not mesh_calls, "mesh decode engaged on misaligned geometry"
    assert any("sharded decode fallback" in r.message
               and r.levelname == "WARNING" for r in caplog.records)


def test_mesh_sharded_matches_single_chip_format():
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    data = synthesize_fastq(700, read_len=36, seed=22)
    cfg1 = CodecConfig(subblock_input_bytes=1 << 30, records_per_substream=16)
    cfg4 = CodecConfig(subblock_input_bytes=1 << 30, records_per_substream=16,
                       data_shards=4)
    c1 = compress_bytes(data, cfg1, 1)
    c4 = compress_bytes(data, cfg4, 1)
    # same decoder, same bytes back; containers need not be identical but
    # both must round-trip
    assert decompress_bytes(c1) == data
    assert decompress_bytes(c4) == data


def test_quality_above_127_rejected():
    """Quality bytes >= 128 collide with the ambiguity-transfer encoding and
    must be rejected up front, not silently corrupted (review finding)."""
    data = b"@r1\nACGT\n+\n\xc8FFF\n" + synthesize_fastq(20, read_len=4, seed=40)
    with pytest.raises(Exception, match="quality byte >= 128"):
        compress_bytes(data, CFG, 1)


def test_empty_read_records_roundtrip():
    """Minimum-size records (empty sequence lines) survive the round trip."""
    data = b"@a\n\n+\n\n@b\nAC\n+\nII\n@c\n\n+\n\n" * 20
    comp = compress_bytes(data, CFG, 1)
    assert decompress_bytes(comp) == data


def test_empty_input():
    comp = compress_bytes(b"", CFG, 2)
    assert decompress_bytes(comp) == b""


def test_deterministic_output():
    """Same input → byte-identical container (no nondeterministic device or
    ordering behavior — the reference's timestamp protocol was explicitly
    non-deterministic; ours must not be)."""
    data = synthesize_fastq(800, read_len=36, seed=55)
    c1 = compress_bytes(data, CFG, 3)
    c2 = compress_bytes(data, CFG, 3)
    assert c1 == c2


def test_rows_pack_roundtrip(monkeypatch):
    """Every bitpack kernel (scatter, the sort-compaction rows plane and its
    on-device compaction) end-to-end: identical container bytes and a
    byte-exact round trip in every mode."""
    data = synthesize_fastq(2000, read_len=36, seed=8,
                            variable_length=True, ambiguity_rate=0.05)
    outs = []
    for mode in ("rows", "rows_compact", "scatter"):
        monkeypatch.setenv("PHYNGSC_PACK", mode)
        outs.append(check(data, n_writers=2))
    assert outs[0] == outs[1] == outs[2]


def test_packed_output_fetch_edge_alphabets():
    """Decode D2H lane packing: high quality values (q6 off), IUPAC-rich
    DNA (wide alphabet / raw fallback), and pure ACGT (2-bit) all round-trip."""
    import numpy as np

    from phyngsc_tpu.config import CodecConfig
    from phyngsc_tpu.pipeline.compress import compress_bytes
    from phyngsc_tpu.pipeline.decompress import decompress_bytes

    rng = np.random.default_rng(0)
    cfg = CodecConfig(subblock_input_bytes=1 << 21, max_records_per_subblock=2048)

    def fastq(seq_alpha, qlo, qhi, n=900, L=31):
        recs = []
        for i in range(n):
            s = rng.choice(np.frombuffer(seq_alpha, np.uint8), size=L).tobytes()
            q = rng.integers(qlo, qhi + 1, L).astype(np.uint8).tobytes()
            recs.append(b"@r%d x\n%s\n+\n%s\n" % (i, s, q))
        return b"".join(recs)

    for data in (
        fastq(b"ACGT", 33, 73),          # 2-bit seq index, 6-bit qual
        fastq(b"ACGTN", 33, 126),        # 3-bit seq index, q6 off
        fastq(b"ACGTNRYSWKMBDHV", 35, 40),  # wide IUPAC: raw fallback likely
    ):
        comp = compress_bytes(data, cfg, 1)
        assert decompress_bytes(comp) == data


def _iupac_fastq(n, rate, seed=0, read_len=36):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTNYRWSKMDVHB", np.uint8)
    probs = np.full(15, rate / 11)
    probs[:4] = (1 - rate) / 4
    recs = []
    for i in range(n):
        seq = rng.choice(alphabet, size=read_len, p=probs)
        qual = rng.integers(33, 41, size=read_len).astype(np.uint8)
        recs.append(b"@ex%d\n" % i + seq.tobytes() + b"\n+\n"
                    + qual.tobytes() + b"\n")
    return b"".join(recs)


def test_qual8_packed_output_fetch():
    """Rich restored alphabet (> 8 symbols) at a realistic sub-percent
    IUPAC rate: the decode output ships PRE-restore (kept-symbol indices +
    raw 8-bit qual_t) and the host applies the ambiguity restore
    (subblock._decode_tail qual8 mode)."""
    from phyngsc_tpu.pipeline import subblock as sbmod

    cfg = CodecConfig(subblock_input_bytes=256 << 10,
                      records_per_substream=8)
    data = _iupac_fastq(800, rate=0.01, seed=41)
    seen = []
    orig = sbmod._decode_dispatch

    def spy(*a, **kw):
        out = orig(*a, **kw)
        if out[6] is not None:
            seen.append(out[6][4])      # out_meta qual8 flag
        return out

    import pytest

    mp = pytest.MonkeyPatch()
    mp.setattr(sbmod, "_decode_dispatch", spy)
    try:
        blob = compress_bytes(data, cfg)
        assert decompress_bytes(blob, cfg) == data
    finally:
        mp.undo()
    assert seen and all(seen), "qual8 fetch mode did not engage"


def test_qual8_dense_iupac_roundtrip():
    """Dense non-ACGT content (60% IUPAC) — the case that used to overflow
    the exception budget — round-trips through the same qual8 fetch with no
    special casing."""
    data = _iupac_fastq(600, rate=0.6, seed=42)
    cfg = CodecConfig(subblock_input_bytes=256 << 10,
                      records_per_substream=8)
    blob = compress_bytes(data, cfg)
    assert decompress_bytes(blob, cfg) == data


def test_decompress_h2d_within_5pct_of_payload(monkeypatch):
    """The fused decode upload stays within 5% of the compressed container
    bytes: tight words, tables as 4-bit lengths, u16 substream tables,
    geometric blob bucketing. Measured via the pipeline's own transfer
    accounting on the walk kernel's path."""
    import numpy as np

    from phyngsc_tpu.pipeline import subblock as sbmod

    monkeypatch.setenv("PHYNGSC_WALK", "kernel")
    monkeypatch.setenv("PHYNGSC_TIMING", "1")
    data = synthesize_fastq(60000, read_len=36, seed=13,
                            ambiguity_rate=0.005)
    cfg = CodecConfig(subblock_input_bytes=1 << 30,
                      max_records_per_subblock=1 << 16,
                      records_per_substream=64)
    comp = compress_bytes(data, cfg, 1)
    assert decompress_bytes(comp, cfg) == data
    h2d = (sbmod.TIMING or {}).get("h2d_bytes", 0.0)
    assert h2d > 0, "transfer accounting did not run"
    assert h2d <= len(comp) * 1.05, (h2d, len(comp))
