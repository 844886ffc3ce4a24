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
                                   alt=tr.alt, known=tr.known)
    else:
        j = jpe.align_batch_pe(
            jr.genome, jr.index, *j_args,
            jpe.PEParams(gapped=jgp, pairmax=jr._pairmax()),
            index_minus=jr.index_minus, alt=jr.alt, known=jr.known)
        t = tpe.align_batch_pe(
            tr.genome, tr.index, *t_args,
            tpe.PEParams(gapped=tgp, pairmax=tr._pairmax()), alt=tr.alt,
            known=tr.known)
    return j, t


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
