"""Port parity for what the gmap CLI runs beneath its parser, on the CPU:
the multipath and chimera alignment of align/gmap.py (align_cdna_paths,
align_cdna_chimera, rank_paths, path_mapqs, path_goodness, and
align_cdna_batch with npaths 1 and 10) Path for Path
against the JAX package; every writer of io/gmap_out.py and
io/gmap_align_fmt.py byte-equal on the same Paths (aligned once by the
JAX package and carried across with torch_parity.port_path) under their
options; inquery.classify / set_inquery; the refusal of a query longer
than the GMAP engine aligns; and the sticky seeding budgets, which change
how often K9 runs, never a result."""

import numpy as np
import pytest

from gmap_gsnap_tpu.align import gmap as jgmap
from gmap_gsnap_tpu.align import inquery as jinq
from gmap_gsnap_tpu.db import datadir as jdatadir
from gmap_gsnap_tpu.db import iit as jiit
from gmap_gsnap_tpu.io import gmap_align_fmt as jfmt
from gmap_gsnap_tpu.io import gmap_out as jout
from gmap_gsnap_tpu.utils import dna as jdna
from gmap_gsnap_tpu_torch.align import gmap as tgmap
from gmap_gsnap_tpu_torch.align import inquery as tinq
from gmap_gsnap_tpu_torch.db import datadir as tdatadir
from gmap_gsnap_tpu_torch.db import iit as tiit
from gmap_gsnap_tpu_torch.io import gmap_align_fmt as tfmt
from gmap_gsnap_tpu_torch.io import gmap_out as tout
from torch_parity import (fresh_jax_caches, gmap_path_fields, gmap_world,
                          one_torch_thread, port_path)


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), one_torch_thread():
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = gmap_world(str(tmp_path_factory.mktemp("gmapfmt")))
    path = f"{w['d']}/syn"
    w["jdb"] = jdatadir.GenomeDB.open(path, "syn")
    w["tdb"] = tdatadir.GenomeDB.open(path, "syn")
    return w


def _fields(paths):
    return [gmap_path_fields(p) for p in paths]


def _queries(world):
    """Every query of the world, and one shorter than k."""
    return [r.seq for r in world["records"]] + ["ACGTACGTAC"]


@pytest.mark.parametrize("il", [1_000_000, 30])
def test_align_cdna_paths_match_jax(world, il):
    """align_cdna_paths (npaths 10) on every query kind: the ranked,
    non-overlapping Paths field for field (None for the short query),
    with their goodness and MAPQs."""
    jdb, tdb = world["jdb"], world["tdb"]
    multi = 0
    for q in _queries(world):
        jp = jgmap.align_cdna_paths(jdb, q, max_intronlen=il)
        tp = tgmap.align_cdna_paths(tdb, q, max_intronlen=il, device="cpu")
        if jp is None:
            assert tp is None
            continue
        assert _fields(tp) == _fields(jp)
        assert ([tgmap.path_goodness(p) for p in tp]
                == [jgmap.path_goodness(p) for p in jp])
        assert tgmap.path_mapqs(tp) == jgmap.path_mapqs(jp)
        multi += len(tp) > 1
    assert multi >= 2    # the duplicated segments


def test_rank_paths_matches_jax(world):
    """rank_paths on the unranked union of both strands' candidates of
    several queries (ties in goodness, overlaps, both strands)."""
    jdb = world["jdb"]
    pool = []
    for q in _queries(world)[:12]:
        pool += jgmap.align_cdna_paths(jdb, q) or []
    pool += [p for p in pool[::3]]          # exact duplicates overlap
    rng = np.random.default_rng(3)
    for _ in range(4):
        order = rng.permutation(len(pool))
        jp = [pool[i] for i in order]
        assert (_fields(tgmap.rank_paths([port_path(p) for p in jp]))
                == _fields(jgmap.rank_paths(jp)))


@pytest.mark.parametrize("margin,overlap", [(40, 0), (40, 5), (200, 0)])
def test_align_cdna_chimera_matches_jax(world, margin, overlap):
    """align_cdna_chimera from each query's best path: the parts and the
    breakpoint (chimeras split, other queries stay whole)."""
    jdb, tdb = world["jdb"], world["tdb"]
    split = 0
    for q in _queries(world)[:-1]:
        jbest = jgmap.align_cdna_paths(jdb, q)
        tbest = tgmap.align_cdna_paths(tdb, q, device="cpu")
        if not jbest:
            continue
        jp, jb = jgmap.align_cdna_chimera(jdb, q, best=jbest[0],
                                          margin=margin, overlap=overlap)
        tp, tb = tgmap.align_cdna_chimera(tdb, q, best=tbest[0],
                                          margin=margin, overlap=overlap,
                                          device="cpu")
        assert tb == jb and _fields(tp) == _fields(jp)
        split += jb is not None
    assert split >= (2 if margin == 40 else 0)


def test_align_cdna_batch_npaths_match_jax(world):
    """align_cdna_batch over a batch with npaths 1 (K10's backtrack) and
    10 (the host multi-chain backtrack over K10's score / prev)."""
    jdb, tdb = world["jdb"], world["tdb"]
    qs = _queries(world)[:-1]
    jp = jgmap.align_cdna_batch(jdb, qs)
    tp = tgmap.align_cdna_batch(tdb, qs, device="cpu")
    assert _fields(tp) == _fields(jp)
    jp = jgmap.align_cdna_batch(jdb, qs, npaths=10)
    tp = tgmap.align_cdna_batch(tdb, qs, npaths=10, device="cpu")
    assert [_fields(p) for p in tp] == [_fields(p) for p in jp]
    assert max(len(p or []) for p in tp) > 1


def test_sticky_budgets_change_no_result(world):
    """A repeat-rich query overflows K9's budgets and leaves larger ones
    for its Q; a plain query at the same Q then aligns as it does from
    the default budgets."""
    tdb = world["tdb"]
    g = world["genome"]
    unit = g.ascii[g.repeats[0] : g.repeats[0] + g.repeat_unit]
    rep = (unit.tobytes().decode() * 3)[:1000]
    plain = world["records"][0].seq[:1000]
    tgmap._HS_STICKY.clear()
    try:
        fresh = tgmap.align_cdna_paths(tdb, plain, device="cpu")
        tgmap._HS_STICKY[1024] = (64, 8)     # force the overflow
        tgmap.align_cdna_paths(tdb, rep, device="cpu")
        assert tgmap._HS_STICKY[1024] != (64, 8)
        grown = dict(tgmap._HS_STICKY)
        again = tgmap.align_cdna_paths(tdb, plain, device="cpu")
        assert tgmap._HS_STICKY == grown
        assert _fields(again) == _fields(fresh)
    finally:
        tgmap._HS_STICKY.clear()


def test_query_past_the_engine_refused(world):
    """A query longer than 65,536 + k - 1 bases raises ValueError naming
    its length (JAX fails on it at its oligo assignment); one base
    shorter aligns."""
    tdb = world["tdb"]
    n = 65_536 + tdb.k - 1
    rng = np.random.default_rng(5)
    q = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n + 1)]
    q = q.tobytes().decode()
    with pytest.raises(ValueError, match=f"query of {n + 1} bases"):
        tgmap.align_cdna_paths(tdb, q, device="cpu")
    with pytest.raises(ValueError):
        jgmap.align_cdna_paths(world["jdb"], q)
    assert isinstance(tgmap.align_cdna_paths(tdb, q[:n], device="cpu"), list)


# ------------------------------------------------------------ writers

@pytest.fixture(scope="module")
def aligned(world):
    """(record, [JAX Path], breakpoint or None) for the queries the
    writers print: both strands, a bench-style query, the chimeras and
    a duplicated segment."""
    jdb = world["jdb"]
    out = []
    for r in world["records"]:
        if r.label not in ("c0", "c1", "c3", "b0", "x0", "x1", "dup0"):
            continue
        paths = jgmap.align_cdna_paths(jdb, r.seq)
        ch, bp = jgmap.align_cdna_chimera(jdb, r.seq, best=paths[0])
        out.append((r, ch if bp is not None else paths, bp))
    assert any(bp is not None for _, _, bp in out)
    return out


def _chr(db, p):
    c = int(np.searchsorted(db.chr_ends, p.gstart, side="right"))
    return (db.chr_names[c], int(db.chr_starts[c]),
            int(db.chr_ends[c] - db.chr_starts[c]))


def _qstr(r, p):
    s = r.seq.upper()
    return s if p.watsonp else jdna.revcomp_str(s)


def _write(kind, opt, out, fmt, db, r, paths, bp, iit):
    """The text one writer prints for a query's Paths (out / fmt are
    either package's io modules, db its GenomeDB, iit its map)."""
    gstr = db.genome_str
    p = paths[0]
    name, cs, clen = _chr(db, p)
    q = _qstr(r, p)
    if kind == "paths_output":
        return out.paths_output(
            r.header, paths, name, clen, q, gstr, True, chimera_pos=bp,
            read=r.seq.upper(), maxpaths=opt, dbname=db.dbname,
            chr_start=cs, chrinfo=None if bp is not None else
            [_chr(db, x)[::2] + (_chr(db, x)[1],) for x in paths])
    if kind == "path_summary":
        return "".join(out.path_summary(x, i + 1, *_chr(db, x)[::2],
                                        _qstr(r, x), gstr, translate=opt,
                                        dbname=db.dbname,
                                        chr_start=_chr(db, x)[1])
                       for i, x in enumerate(paths))
    if kind == "sam_record":
        return "".join(out.sam_record(
            x, r.label, r.seq, None, _chr(db, x)[0], _chr(db, x)[1],
            _qstr(r, x), gstr, nh=len(paths), hi=i + 1, hardclip=opt,
            extra=["XT:Z:NN-NN,0.00,0.00"] if opt else None)
            for i, x in enumerate(paths))
    if kind == "chimera_aa_maps":
        return repr(out.chimera_aa_maps(paths, gstr)) if bp else ""
    if kind == "compressed_output":
        return out.compressed_output(p, r.label, 1, 1, name, cs, qstr=q,
                                     gstr=gstr, dbname=opt)
    if kind == "psl_output":
        return out.psl_output(p, r.label, name, cs, clen)
    if kind in ("splicesites_output", "introns_output"):
        return getattr(out, kind)(p, r.label, name)
    if kind == "map_output":
        return out.map_output(p, r.label, r.header, name, opt, chr_start=cs)
    if kind == "gff3_gene":
        return out.gff3_gene(p, 1, r.label, name, db.dbname, q, gstr,
                             chr_start=cs)
    if kind == "gff3_match":
        return out.gff3_match(p, 1, r.label, name, db.dbname, q, gstr,
                              est=opt, chr_start=cs)
    if kind == "coords_output":
        return out.coords_output(p, r.header, q, gstr, name, cs)
    if kind == "map_hits":
        return "".join(out.map_hits(x, i + 1, iit, "genes", *_chr(db, x)[:2],
                                    **opt) for i, x in enumerate(paths))
    if kind == "map_hits_exons":
        return "".join(out.map_hits_exons(x, i + 1, iit, "genes",
                                          *_chr(db, x)[:2], **opt)
                       for i, x in enumerate(paths))
    if kind == "exon_table":
        return "".join(fmt.exon_table(x, _chr(db, x)[1], _chr(db, x)[0],
                                      codes=db.codes, invertmode=opt)
                       for x in paths)
    if kind == "alignment_body":
        return "".join(fmt.alignment_body(x, _qstr(r, x), gstr,
                                          *_chr(db, x)[1::-1], **opt)
                       for x in paths)
    if kind in ("continuous_body", "continuous_by_exon_body"):
        return "".join(getattr(fmt, kind)(x, _qstr(r, x), gstr,
                                          invertmode=opt) for x in paths)
    if kind == "exons_output":
        return fmt.exons_output(p, r.header, q, gstr, opt)
    if kind == "protein_output":
        return fmt.protein_output(p, r.header, q, gstr, opt)
    raise KeyError(kind)


WRITERS = [
    ("paths_output", None), ("paths_output", 1), ("path_summary", True),
    ("path_summary", False), ("sam_record", False), ("sam_record", True),
    ("chimera_aa_maps", None), ("compressed_output", "syn"),
    ("compressed_output", None), ("psl_output", None),
    ("splicesites_output", None), ("introns_output", None),
    ("map_output", False), ("map_output", True), ("gff3_gene", None),
    ("gff3_match", False), ("gff3_match", True), ("coords_output", None),
    ("map_hits", {}), ("map_hits", dict(bothstrands=True)),
    ("map_hits", dict(nflanking=1, print_comment=True)),
    ("map_hits_exons", {}), ("map_hits_exons", dict(print_comment=True)),
    ("exon_table", 0), ("exon_table", 1), ("exon_table", 2),
    ("alignment_body", {}), ("alignment_body", dict(invertmode=1)),
    ("alignment_body", dict(invertmode=2, wraplength=60)),
    # -i past 3 raises IndexError on minus-strand paths in the JAX
    # package (its _read_order_cols re-labels 9 intron columns; the
    # port's prints, test_alignment_body_minus_wide_ngap)
    ("alignment_body", dict(ngap=2, nolengths=True)),
    ("alignment_body", dict(nolengths=True)),
    ("continuous_body", 0), ("continuous_body", 2),
    ("continuous_by_exon_body", 0), ("continuous_by_exon_body", 1),
    ("exons_output", False), ("exons_output", True),
    ("protein_output", False), ("protein_output", True)]


@pytest.mark.parametrize("kind,opt", WRITERS,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(WRITERS)])
def test_writer_byte_equal(world, aligned, kind, opt):
    maps = f"{world['d']}/syn/syn.maps/genes.iit"
    jmap, tmap = jiit.IIT.read(maps), tiit.IIT.read(maps)
    texts = []
    for r, jpaths, bp in aligned:
        tpaths = [port_path(p) for p in jpaths]
        j = _write(kind, opt, jout, jfmt, world["jdb"], r, jpaths, bp, jmap)
        t = _write(kind, opt, tout, tfmt, world["tdb"], r, tpaths, bp, tmap)
        assert t == j, (kind, opt, r.label)
        texts.append(t)
    assert any(texts)


def _minus_spliced(aligned):
    """(record, port Path, JAX Path) of the minus-strand paths with an
    intron among the writers' queries."""
    out = [(r, port_path(p), p) for r, paths, _ in aligned for p in paths
           if not p.watsonp and len(p.exons) > 1]
    assert out
    return out


def _intron_numbers(cols) -> list:
    """The intron length each run of intron columns prints in its query
    row, in column order."""
    nums, run = [], []
    for c in cols + [{}]:
        if c.get("intron"):
            run.append(c["q"])
        elif run:
            nums.append("".join(run).strip())
            run = []
    return nums


@pytest.mark.parametrize("ngap", [2, 3])
def test_alignment_body_minus_ngap_byte_equal(world, aligned, ngap):
    """gmap -A -i 2 and 3 on minus-strand paths, with intron lengths:
    byte-equal to the JAX package (the repair of -i past 3 leaves them
    as they were)."""
    for r, tp, jp in _minus_spliced(aligned):
        j = jfmt.alignment_body(jp, _qstr(r, jp), world["jdb"].genome_str,
                                *_chr(world["jdb"], jp)[1::-1], ngap=ngap)
        t = tfmt.alignment_body(tp, _qstr(r, tp), world["tdb"].genome_str,
                                *_chr(world["tdb"], tp)[1::-1], ngap=ngap)
        assert t == j


@pytest.mark.parametrize("ngap", [4, 8])
def test_alignment_body_minus_wide_ngap(world, aligned, ngap):
    """gmap -A -i past 3 on a minus-strand path prints (the JAX package
    raises IndexError there, so it has no output to match): each intron
    shows the length that the aligned-order columns, the plus-path
    rendering, centre for it, in the run's 2 ngap + 3 columns."""
    gstr = world["tdb"].genome_str
    for r, tp, jp in _minus_spliced(aligned):
        q = _qstr(r, tp)
        with pytest.raises(IndexError):
            jfmt.alignment_body(jp, _qstr(r, jp), world["jdb"].genome_str,
                                *_chr(world["jdb"], jp)[1::-1], ngap=ngap)
        text = tfmt.alignment_body(tp, q, gstr,
                                   *_chr(world["tdb"], tp)[1::-1], ngap=ngap)
        acols = tfmt._columns(tp, q, gstr, ngap=ngap)
        plus = _intron_numbers(acols)
        shown = _intron_numbers(tfmt._display_cols(tp, acols, 0))
        assert shown == plus[::-1] and all(n.isdigit() for n in shown)
        gaps = [b.gstart - a.gend for a, b in zip(tp.exons, tp.exons[1:])
                if b.gstart - a.gend >= 9]
        assert sorted(map(int, shown)) == sorted(gaps)
        assert all(n in text for n in shown)


def test_inquery_matches_jax(world):
    """classify and set_inquery on random, poly-A, low-complexity and
    planted queries, and on queries shorter than the 8-mer window."""
    rng = np.random.default_rng(11)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    qs = [r.seq for r in world["records"]]
    qs += [acgt[rng.integers(0, 4, n)].tobytes().decode()
           for n in (5, 8, 9, 60, 79, 80, 81, 300)]
    qs += ["A" * 200, "A" * 150 + qs[0][:60], "CA" * 100, "CAG" * 70,
           "ACGTN" * 40, "N" * 50, qs[1][:100] + "T" * 120]
    poor = 0
    for q in qs:
        assert tinq.set_inquery(q) == jinq.set_inquery(q)
        assert tinq.classify(q) == jinq.classify(q)
        poor += tinq.classify(q)[0]
    assert 0 < poor < len(qs)


def test_lazy_genome_str_matches_jax(world):
    """The writers index the genome string as the JAX writers do: single
    positions (negative ones too), slices, empty and reversed slices, and
    slices past the genome's end, with the same answers and length."""
    j, t = world["jdb"].genome_str, world["tdb"].genome_str
    n = len(j)
    assert len(t) == n
    for i in (0, 1, 1000, n - 1, -1, -n):
        assert t[i] == j[i]
    for a, b in ((0, 10), (n - 5, n + 20), (n, n + 3), (500, 400),
                 (-10, None), (None, 7), (12, 12), (n - 2, None)):
        assert t[a:b] == j[a:b]
    for i in (n, n + 5):
        with pytest.raises(IndexError):
            t[i]
        with pytest.raises(IndexError):
            j[i]
