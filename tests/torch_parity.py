"""Shared by the port's parity tests: hand the JAX package the same
database the port's loader built, and build the -s / -v test world
(which a process without JAX rebuilds too, so this module imports the
JAX package only inside jax_db)."""

import contextlib
import dataclasses


def jax_db(db):
    """The JAX package's GenomeDB over the arrays of the port's ``db``
    (same fields; the index arrays shared, not re-read), so the JAX
    runner can build its device arrays from it."""
    from gmap_gsnap_tpu.db import datadir as jdatadir

    j = jdatadir.GenomeDB(**{f.name: getattr(db, f.name)
                             for f in dataclasses.fields(db)})
    j.offsets, j.positions = db.offsets, db.positions
    return j


def site_snp_world(d, seed: int = 31):
    """A ~1 Mbp synthetic genome with a splicesites map and a SNP index
    written into directory ``d`` (sites.iit, snps.iit and the "snps" SNP
    index of db/transforms.write_snp_index), and reads and pairs for -s /
    -v runs: planted junction, short-end, non-canonical, SNP-heavy and
    ordinary reads, RNA pairs plus pairs made of those reads and
    inside-ambiguous pairs.  Returns a dict."""
    import os

    import numpy as np

    from gmap_gsnap_tpu_torch.db import iit_text, transforms
    from gmap_gsnap_tpu_torch.utils import synth

    rng = np.random.default_rng(seed)
    g = synth.make_genome(rng, [500_000, 350_000, 150_000])
    db = synth.genome_db(g, 12, 3)
    introns = synth.random_introns(rng, g, 300)
    nc = synth.random_introns(rng, g, 30, canonical=False)
    decoys = synth.random_decoys(rng, g, 200)
    a1, a2, _, amb = synth.inside_ambiguous_pairs(rng, g, 8)
    srecs, struth = synth.plant_spliced_reads(rng, g, 40)
    sense = lambda a: g.ascii[a : a + 2].tobytes() == b"GT"
    planted = [synth.Intron(a, b, sense(a)) for t in struth
               for a, b in t.junctions if 0 < b - a < 200_000]
    kr, kt = synth.plant_site_reads(rng, g, introns, 30, short_end=True)
    cr, ct = synth.plant_site_reads(rng, g, nc, 20, prefix="c")
    vr, vt, (sp, sa) = synth.plant_snp_reads(rng, g, 40)
    bp, ba = synth.random_snps(rng, g, 1 / 1000)
    pos, first = np.unique(np.concatenate([sp, bp]), return_index=True)
    alt = np.concatenate([sa, ba])[first]
    sites_text = synth.splicesites_text(g, planted + introns + nc + amb,
                                        decoys)
    iit_text.iit_from_text(sites_text).write(os.path.join(d, "sites.iit"))
    snps_text = synth.snps_text(g, pos, alt)
    snps = iit_text.iit_from_text(snps_text)
    snps.write(os.path.join(d, "snps.iit"))
    codes, flags = g.codes_flags
    alt_codes = transforms.alt_genome_from_snps(codes, snps, db.chr_names,
                                                db.chr_starts)
    transforms.write_snp_index(d, db.dbname, "snps", codes, flags,
                               db.chr_ends, alt_codes, k=12, interval=3)
    p1, p2, _ = synth.plant_pairs(rng, g, 40, rna=True)
    extra = vr[:20] + kr[:15] + cr[:10]
    spans = ([(t.left, t.left + 100, t.plusp) for t in vt[:20]]
             + [(t.left, t.intron.acceptor + t.flanks[1], t.plusp)
                for t in kt[:15] + ct[:10]])
    mates = synth.mates_for(rng, g, extra, spans)
    reads = srecs + kr + cr + vr
    p1, p2 = p1 + extra + a1, p2 + mates + a2
    # reads and pairs that overflow a candidate budget (those in repeat
    # copies) would make every JAX runner configuration compile its wide
    # lanes too; the tests of align_batch_* cover the overflow gates, so
    # the runner tests leave such reads out
    from gmap_gsnap_tpu_torch.align import runner

    over = set()
    for kw in ({}, dict(snpsdb="snps", snps_dir=str(d))):
        r = runner.GsnapRunner(db, device="cpu", **kw)
        res = r.align_records(reads)
        over |= {x.label for x, o in zip(reads, res["overflow"]) if o}
        res = r.align_pairs(p1, runner.invert_records(p2))
        over |= {x.label for x, o5, o3 in zip(p1, res["end5"]["overflow"],
                                               res["end3"]["overflow"])
                 if o5 or o3}
    keep = [i for i, x in enumerate(p1) if x.label not in over]
    return dict(genome=g, db=db, dir=str(d), sites_text=sites_text,
                snps_text=snps_text,
                snp_reads=[x for x in vr if x.label not in over],
                snp_truth=[t for x, t in zip(vr, vt) if x.label not in over],
                reads=[x for x in reads if x.label not in over],
                pairs=([p1[i] for i in keep], [p2[i] for i in keep]))


def runner_params(mod, db, **changes):
    """``mod.GsnapParams()`` (either package's) with the runner's dynamic
    size threshold, as GsnapRunner(db) builds it, and ``changes``."""
    p = mod.GsnapParams()
    return dataclasses.replace(
        p, size_threshold=mod.dynamic_size_threshold(int(db.offsets[-1]),
                                                     db.k, p.mode),
        **changes)


@contextlib.contextmanager
def fresh_jax_caches():
    """Drop JAX's compiled executables before and after the block.  Each
    XLA CPU executable holds memory maps of its own, and the JAX runner's
    -s / -v configurations compile many large ones: two such test files
    in one process left ~55,000 maps (Linux's default vm.max_map_count is
    65,530; jax.clear_caches() brings them back to ~800), and XLA crashed
    (SIGSEGV) compiling in the third."""
    import jax

    jax.clear_caches()
    try:
        yield
    finally:
        jax.clear_caches()


@contextlib.contextmanager
def jax_runner_one_device():
    """The JAX runner on one device inside the block.  tests/conftest.py
    gives JAX eight virtual CPU devices, on which the runner shards every
    batch over a mesh (its data-parallel path, whose SAM equals one
    device's: MULTICHIP_r05.json); compiling those sharded programs for
    each -s / -v configuration cost the test files several times their
    one-device time."""
    from gmap_gsnap_tpu.align import runner as jrun

    init_mesh = jrun.GsnapRunner._init_mesh

    def one_device(self):
        self._ndev = 1
        self.mesh = None

    jrun.GsnapRunner._init_mesh = one_device
    try:
        yield
    finally:
        jrun.GsnapRunner._init_mesh = init_mesh


def align_batch_as_runners(jr, tr, recs, recs3=None):
    """align_batch_gapped (or, with read-2 records, align_batch_pe) of
    one batch through both packages, with each runner's own device
    state (genome, index, alt genome, known sites) and parameters, the
    call the runners' dispatch makes (so the JAX package reuses the
    program its runner compiled).  Returns (JAX tree, port tree)."""
    import jax.numpy as jnp
    import torch

    from gmap_gsnap_tpu.align import gsnap_gapped as jgg
    from gmap_gsnap_tpu.align import gsnap_pe as jpe
    from gmap_gsnap_tpu_torch.align import gsnap_gapped as tgg
    from gmap_gsnap_tpu_torch.align import gsnap_pe as tpe
    from gmap_gsnap_tpu_torch.align import runner as trun

    enc = trun.encode_batch(recs, jr.lmax)
    if recs3 is not None:
        enc = enc + trun.encode_batch(trun.invert_records(recs3), jr.lmax)
    j_args = [jnp.asarray(x) for x in enc]
    t_args = [torch.from_numpy(x) for x in enc]
    lens = enc[2::3]
    jgp, tgp = jr._gp_uniform(jr.gapped_params, *lens), tr._gp_uniform(
        tr.gapped_params, *lens)
    if recs3 is None:
        j = jgg.align_batch_gapped(jr.genome, jr.index, *j_args, jgp,
                                   index_minus=jr.index_minus, alt=jr.alt,
                                   known=jr.known)
        t = tgg.align_batch_gapped(tr.genome, tr.index, *t_args, tgp,
                                   index_minus=tr.index_minus, alt=tr.alt,
                                   known=tr.known)
    else:
        j = jpe.align_batch_pe(
            jr.genome, jr.index, *j_args,
            jpe.PEParams(gapped=jgp, pairmax=jr._pairmax()),
            index_minus=jr.index_minus, alt=jr.alt, known=jr.known)
        t = tpe.align_batch_pe(
            tr.genome, tr.index, *t_args,
            tpe.PEParams(gapped=tgp, pairmax=tr._pairmax()),
            index_minus=tr.index_minus, alt=tr.alt, known=tr.known)
    return j, t


def same_tree(j, t, path=""):
    """JAX result tree vs the port's: same keys, shapes and values
    (float32 by their bits)."""
    import numpy as np

    if isinstance(j, dict):
        assert set(j) == set(t), (path, set(j) ^ set(t))
        for k in j:
            same_tree(j[k], t[k], f"{path}.{k}")
        return
    a, b = np.asarray(j), t.numpy()
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if a.dtype == np.float32:
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), path
    else:
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), path


@contextlib.contextmanager
def one_torch_thread():
    """torch on one intra-op thread inside the block.  The parity tests'
    tensors are small, and the test suite runs six worker processes on
    the machine's cores: each process's torch thread pool spinning on
    them slowed the other workers more than it sped these tests up."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


GMAP_LANE_KINDS = dict(sub=4, n=1, mid_indel=1.5, end_indel=1.5,
                       terminal=1.5, repeat=1.5, junk=0.5)


def gmap_lanes_world():
    """The GMAP lane tests' world: a 300 kbp genome, 150 planted DNA
    reads of every kind and 60 spliced / messy-junction reads, 100 RNA
    pairs: (genome, db, the JAX package's db, reads, (read 1s, read 2s))."""
    import numpy as np

    from gmap_gsnap_tpu_torch.utils import synth

    rng = np.random.default_rng(11)
    g = synth.make_genome(rng, [150_000, 100_000, 50_000])
    db = synth.genome_db(g, 12, 3)
    recs, _ = synth.plant_reads(rng, g, 150, weights=GMAP_LANE_KINDS)
    srecs, _ = synth.plant_spliced_reads(
        np.random.default_rng(5), g, 60,
        weights=dict(unspliced=0.3, junction=0.3, messy_junction=0.4))
    p1, p2, _ = synth.plant_pairs(np.random.default_rng(9), g, 100, rna=True)
    return g, db, jax_db(db), recs + srecs, (p1, p2)


def count_lanes(monkeypatch, runner):
    """Install the lane counters on ``runner`` (and the port's
    select_final, solve_junctions_finish and prefetch_gmap)."""
    from gmap_gsnap_tpu_torch.align import gmap_engine as teng
    from gmap_gsnap_tpu_torch.align import rescue as trescue

    seen = dict(prefetch=0, prefetched_reads=0, terminal=0, improvement=0,
                pairsearch=0, dynprog=0)
    select_final, finish = trescue.select_final, teng.solve_junctions_finish
    prefetch, pe_rescue = runner.prefetch_gmap, runner._pe_rescue

    def spy_select(hits, L, improvement_fn=None, **kw):
        # in _rescued_hits only the terminal lane puts GMAP hits into
        # the pool before select_final
        seen["terminal"] += any(h.hittype == "gmap" for h in hits)

        def improvement(anchor):
            g = improvement_fn(anchor)
            seen["improvement"] += g is not None and g.nmatches > anchor.nmatches
            return g

        return select_final(hits, L, improvement_fn=improvement
                            if improvement_fn else None, **kw)

    def spy_pe_rescue(*a):
        out = pe_rescue(*a)
        chosen, _, f5, f3 = out
        own = {id(h) for h in f5 + f3}
        # a GMAP hit the ends' own lanes did not produce: pairsearch's
        seen["pairsearch"] += any(h.hittype == "gmap" and id(h) not in own
                                  for p in chosen for h in p[:2])
        return out

    def spy_prefetch(recs):
        seen["prefetch"] += 1
        seen["prefetched_reads"] += len(recs)
        return prefetch(recs)

    def spy_finish(d):
        out = finish(d)
        seen["dynprog"] += sum(x is not None for x in out)
        return out

    monkeypatch.setattr(trescue, "select_final", spy_select)
    monkeypatch.setattr(teng, "solve_junctions_finish", spy_finish)
    monkeypatch.setattr(runner, "prefetch_gmap", spy_prefetch)
    monkeypatch.setattr(runner, "_pe_rescue", spy_pe_rescue)
    return seen


def mode_params(mod, db, mode: str, **changes):
    """``mod.GsnapParams(mode=mode)`` (either package's) with the size
    threshold the gsnap CLI computes for ``mode`` (3^k oligos under a
    conversion), so the runner tests share the CLI tests' compiles."""
    return mod.GsnapParams(
        mode=mode, size_threshold=mod.dynamic_size_threshold(
            int(db.offsets[-1]), db.k, mode), **changes)


def modes_world(d, seed: int = 37):
    """A ~600 kbp synthetic genome built on disk into ``d``/syn (the JAX
    package's gmap_build), with the port's cmet and atoi converted
    indexes written into the database directory and into ``d``/conv (for
    --cmetdir / --atoidir), a SNP index "snps" and a splicesites map
    "sites" (for -v / -s together with --mode), planted bisulfite reads
    (some with a read-C / genome-T site), bisulfite pairs (under cmet)
    and A-to-I edited RNA pairs (under atoi).
    Reads and pairs that overflow a candidate budget under either mode
    are left out, so no JAX configuration compiles its wide lanes.
    Returns a dict."""
    import os

    import numpy as np

    from gmap_gsnap_tpu.db import build
    from gmap_gsnap_tpu_torch.align import gsnap_se, runner
    from gmap_gsnap_tpu_torch.db import iit_text, transforms
    from gmap_gsnap_tpu_torch.db.datadir import GenomeDB
    from gmap_gsnap_tpu_torch.utils import synth

    rng = np.random.default_rng(seed)
    g = synth.make_genome(rng, [300_000, 200_000, 100_000])
    g.write_fasta(os.path.join(d, "g.fa"))
    build.build_db([os.path.join(d, "g.fa")], "syn", str(d), k=12)
    dbdir = os.path.join(d, "syn")
    db = GenomeDB.open(dbdir, "syn")
    conv = os.path.join(d, "conv")
    os.makedirs(conv)
    for kind in ("cmet", "atoi"):
        for out in (dbdir, conv):
            transforms.write_converted_indexes(out, "syn", db.codes, db.flags,
                                               db.chr_ends, kind, k=12)
    pos, alt = synth.random_snps(rng, g, 1 / 1000)
    snps = iit_text.iit_from_text(synth.snps_text(g, pos, alt))
    alt_codes = transforms.alt_genome_from_snps(db.codes, snps, db.chr_names,
                                                db.chr_starts)
    transforms.write_snp_index(dbdir, "syn", "snps", db.codes, db.flags,
                               db.chr_ends, alt_codes, k=12, interval=3)
    os.makedirs(os.path.join(dbdir, "syn.maps"), exist_ok=True)
    iit_text.iit_from_text(synth.splicesites_text(
        g, synth.random_introns(rng, g, 100))).write(
            os.path.join(dbdir, "syn.maps", "sites.iit"))
    reads, truth = synth.plant_bisulfite_reads(rng, g, 160, ct_sites=0.15)
    pairs = {"cmet-stranded": synth.plant_bisulfite_pairs(rng, g, 48)[:2],
             "atoi-stranded": synth.plant_edited_pairs(rng, g, 120)[:2]}
    over = set()
    for mode, (p1, p2) in pairs.items():
        single = reads if mode == "cmet-stranded" else p1
        for novel in (False, True):
            r = runner.GsnapRunner(db, mode_params(gsnap_se, db, mode),
                                   novelsplicing=novel, device="cpu")
            res = r.align_records(single)
            over |= {x.label for x, o in zip(single, res["overflow"]) if o}
            res = r.align_pairs(p1, runner.invert_records(p2))
            over |= {x.label for x, o5, o3 in zip(
                p1, res["end5"]["overflow"], res["end3"]["overflow"])
                if o5 or o3}
    keep = [i for i, x in enumerate(reads) if x.label not in over]
    reads = [reads[i] for i in keep]
    for mode, (p1, p2) in pairs.items():
        kept = [i for i, x in enumerate(p1) if x.label not in over]
        pairs[mode] = ([p1[i] for i in kept], [p2[i] for i in kept])
    synth.write_fastq(os.path.join(d, "b.fq"), reads)
    for mode, stem in (("cmet-stranded", "f"), ("atoi-stranded", "e")):
        for m in range(2):
            synth.write_fastq(os.path.join(d, f"{stem}_{m + 1}.fq"),
                              pairs[mode][m])
    return dict(genome=g, db=db, dir=str(d), conv=conv, reads=reads,
                truth=[truth[i] for i in keep], pairs=pairs)


def gmap_world(d, seed: int = 61):
    """The gmap CLI tests' world in directory ``d``: a 300 kbp genome of
    3 chromosomes with two duplicated segments (synth.gmap_repeat_queries)
    built by the port's gmap_build into d/syn (k=12), cDNA queries of
    every kind written to d/q.fa, a genes map stored by the port's
    iit_store into the database's maps folder, a chromosome subset file
    d/subsets.txt, and d/pair.fa (two sequences for -1 / -2).  Returns
    a dict (genome, records, truths, paths of the files)."""
    import os

    import numpy as np

    from gmap_gsnap_tpu_torch.cli import gmap_build, iit_store
    from gmap_gsnap_tpu_torch.io.fasta import Record
    from gmap_gsnap_tpu_torch.utils import synth

    rng = np.random.default_rng(seed)
    g = synth.make_genome(rng, [150_000, 100_000, 50_000])
    reps, rtruth, _ = synth.gmap_repeat_queries(rng, g, 2)
    g.write_fasta(os.path.join(d, "g.fa"))
    assert gmap_build.main(["-d", "syn", "-D", d, "-k", "12",
                            os.path.join(d, "g.fa")]) == 0
    q3, t3 = synth.gmap_queries(rng, g, 6, messy=0.5)
    qb, tb = synth.gmap_queries(rng, g, 2, sites=False, prefix="b")
    qx, tx = synth.gmap_chimeras(rng, g, 2)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    nrich = np.frombuffer(q3[0].seq.encode(), np.uint8).copy()
    nrich[rng.random(len(nrich)) < 0.2] = ord("N")
    rand = acgt[rng.integers(0, 4, 500)].tobytes().decode()
    # a query shorter than k goes in a file of its own: only the Paths
    # format takes one (both CLIs raise TypeError under any other)
    short = Record("short", "short sequence", "ACGTACGTAC")
    synth.write_fasta_records(os.path.join(d, "short.fa"), [short, q3[0]])
    odd = [Record("nrich", "nrich", nrich.tobytes().decode()),
           Record("random", "random", rand),
           Record("polya", "polya", "A" * 180 + rand[:40]),
           Record("lowc", "lowc", "CA" * 120)]
    records = q3 + qb + qx + reps + odd
    synth.write_fasta_records(os.path.join(d, "q.fa"), records)
    # a genes map: intervals over query 0 (plus and minus strand), one
    # exon of query 2, and all of chr3; annotations on some
    starts = dict(zip(g.names, np.concatenate([[0], g.chr_ends[:-1]])))
    (c0, e0), (c2, e2) = ((t.chrom, [(int(a - starts[t.chrom]),
                                      int(b - starts[t.chrom]))
                                     for a, b in t.exons])
                          for t in (t3[0], t3[2]))
    with open(os.path.join(d, "genes.txt"), "w") as f:
        f.write(f">gA {c0}:{e0[0][0] + 1}..{e0[-1][1]} first gene\n"
                f"annotation of gA\n"
                f">gB {c0}:{e0[1][1]}..{e0[1][0] + 1}\nannotation of gB\n"
                f">gC {c2}:{e2[0][0] + 1}..{e2[0][1]} third gene\n"
                f">gD chr3:1..50000 whole chromosome\nannotation of gD\n")
    maps = os.path.join(d, "syn", "syn.maps")
    os.makedirs(maps, exist_ok=True)
    assert iit_store.main(["-o", os.path.join(maps, "genes"),
                           os.path.join(d, "genes.txt")]) == 0
    with open(os.path.join(d, "subsets.txt"), "w") as f:
        f.write(">first\nchr1\n>rest\nchr2\nchr3\n")
    seg = g.ascii[1000:4000].tobytes().decode()
    synth.write_fasta_records(os.path.join(d, "pair.fa"), [
        Record("seg", "seg", seg), Record("sub", "sub part",
                                          seg[500:900] + seg[1400:1900])])
    # a user genomic segment around query 0 (-g)
    lo, hi = t3[0].exons[0][0] - 2000, t3[0].exons[-1][1] + 2000
    synth.write_fasta_records(os.path.join(d, "gseg.fa"), [Record(
        "gseg", "gseg", g.ascii[lo:hi].tobytes().decode())])
    # the core queries most flag sets run: both strands, a bench-style
    # query, a chimera, a repeat query, a random and a poly-A one
    core = [r for r in records if r.label in (
        "c0", "c1", "c2", "b0", "x0", "dup0", "random", "polya")]
    synth.write_fasta_records(os.path.join(d, "core.fa"), core)
    return dict(genome=g, records=records, truths=t3 + tb + tx + rtruth,
                cmdline=f"{seg},{seg[500:900] + seg[1400:1900]}",
                **{name: os.path.join(d, f"{name}.fa")
                   for name in ("q", "core", "short", "pair", "gseg")},
                d=d, subsets=os.path.join(d, "subsets.txt"))


def restore_gmap_globals(monkeypatch):
    """Put back, after the test, the module globals that both packages'
    gmap CLIs set (cli/gmap.py: MIN_INTRONLENGTH, the gmap_config knobs,
    the translation flags)."""
    from gmap_gsnap_tpu.align import gmap as jgmap
    from gmap_gsnap_tpu.align import gmap_config as jcfg
    from gmap_gsnap_tpu.align import translation as jtr
    from gmap_gsnap_tpu_torch.align import gmap as tgmap
    from gmap_gsnap_tpu_torch.align import gmap_config as tcfg
    from gmap_gsnap_tpu_torch.align import translation as ttr

    for mod, names in ((jgmap, ("MIN_INTRONLENGTH",)),
                       (tgmap, ("MIN_INTRONLENGTH",)),
                       (jcfg, ("CANONICAL_MODE", "NOSPLICING", "MINENDEXON")),
                       (tcfg, ("CANONICAL_MODE", "NOSPLICING", "MINENDEXON")),
                       (jtr, ("FULLLENGTH_P", "CDS_STARTPOS")),
                       (ttr, ("FULLLENGTH_P", "CDS_STARTPOS"))):
        for name in names:
            monkeypatch.setattr(mod, name, getattr(mod, name))


def port_path(p):
    """A JAX package's GMAP Path (or None) as the port's Path, field for
    field, so that both packages' writers can print the same Path."""
    from gmap_gsnap_tpu_torch.align import gmap as tgmap

    if p is None:
        return None
    return tgmap.Path(
        watsonp=p.watsonp, cdna_direction=p.cdna_direction,
        exons=[tgmap.Exon(e.qstart, e.qend, e.gstart, e.gend, e.matches,
                          e.mismatches) for e in p.exons],
        intron_types=list(p.intron_types), querylength=p.querylength,
        indels=p.indels, chrnum=p.chrnum)


def gmap_path_fields(p):
    """Every field of a GMAP Path (either package's), for equality."""
    if p is None:
        return None
    return (p.watsonp, p.cdna_direction, tuple(p.intron_types),
            p.querylength, p.indels, p.chrnum,
            tuple((e.qstart, e.qend, e.gstart, e.gend, e.matches,
                   e.mismatches) for e in p.exons))


def gmap_cli_outputs(capsys, args):
    """(JAX stdout, port stdout) of the gmap CLI with args, the port's
    with --device cpu; the exit codes must agree."""
    from gmap_gsnap_tpu.cli import gmap as jcli
    from gmap_gsnap_tpu_torch.cli import gmap as tcli

    rc = jcli.main(args)
    jax = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == rc
    return jax, capsys.readouterr().out
