"""MHAP-compatible command-line overlapper.

Parity target: main/MhapMain.java -- same flags, defaults, presets
(--settings 1/2/3, MhapMain.java:137-198), usage modes (1: -s [-q]
overlap run; 2: -p/-q binary precompute), validation messages, stderr
settings echo / timing spans / final stats (outputFinalStat:572-590),
and M4 results on stdout.

Extensions over the reference: ``--backend device|sharded|oracle``
(device = the JAX pipeline on one device, the default; sharded = the same
pipeline SPMD over every visible device via parallel/sharded.py; oracle
= the bit-exact numpy reference) and FASTQ input support.
"""

from __future__ import annotations

import os
import sys
import time


class Option:
    def __init__(self, name, desc, default):
        self.name = name
        self.desc = desc
        self.default = default
        self.value = default
        self.is_set = False

    def set(self, value):
        t = type(self.default)
        if t is bool:
            self.value = True
        elif t is int:
            self.value = int(value)
        elif t is float:
            self.value = float(value)
        else:
            self.value = value
        self.is_set = True


class ParseOptions:
    """Typed flag parser (utils/ParseOptions.java)."""

    def __init__(self):
        self.options: dict[str, Option] = {}
        self.start_text: list[str] = []

    def add_start_text(self, line):
        self.start_text.append(line)

    def add(self, name, desc, default):
        self.options[name] = Option(name, desc, default)

    def get(self, name) -> Option:
        return self.options[name]

    def help_menu(self) -> str:
        out = list(self.start_text)
        for name in sorted(self.options):
            o = self.options[name]
            out.append(f"\t\t{name} = [{type(o.default).__name__}], "
                       f"default: {o.default}")
            out.append(f"\t\t\t{o.desc}")
        return "\n".join(out)

    def process(self, args) -> bool:
        i = 0
        while i < len(args):
            a = args[i]
            if a in ("-h", "--help"):
                print(self.help_menu())
                return False
            if a == "--version":
                print("2.1.3-jax")
                return False
            if a not in self.options:
                # support -sfile style concatenation for short flags
                matched = None
                for name in self.options:
                    if len(name) == 2 and a.startswith(name) and len(a) > 2:
                        matched = name
                        break
                if matched is None:
                    print(f"Unknown option {a}.")
                    print(self.help_menu())
                    return False
                self.options[matched].set(a[2:])
                i += 1
                continue
            o = self.options[a]
            if type(o.default) is bool:
                o.set(True)
                i += 1
            else:
                if i + 1 >= len(args):
                    print(f"Missing value for option {a}.")
                    return False
                o.set(args[i + 1])
                i += 2
        return True

    def __str__(self):
        rows = []
        for name in sorted(self.options):
            o = self.options[name]
            rows.append(f"{name} = {o.value}")
        return "\n".join(rows)


PRESETS = {
    1: {"-k": 16, "--num-min-matches": 3, "--num-hashes": 512,
        "--threshold": 0.78, "--ordered-sketch-size": 1536,
        "--ordered-kmer-size": 12},
    2: {"-k": 16, "--num-min-matches": 3, "--num-hashes": 256,
        "--threshold": 0.80, "--ordered-sketch-size": 1000,
        "--ordered-kmer-size": 14},
    3: {"-k": 16, "--num-min-matches": 2, "--num-hashes": 768,
        "--threshold": 0.73, "--ordered-sketch-size": 1536,
        "--ordered-kmer-size": 12},
}


def build_options() -> ParseOptions:
    o = ParseOptions()
    o.add_start_text(
        "MHAP (JAX): MinHash Alignment Protocol. A tool for "
        "finding overlaps of long-read sequences (such as PacBio or "
        "Nanopore) in bioinformatics.")
    o.add("-s", "Usage 1 only. The FASTA or binary dat file of reads stored"
          " in a box that all subsequent reads are compared to.", "")
    o.add("-q", "Usage 1: FASTA file/directory compared to the box (-s). "
          "Usage 2: output directory for binary dat files.", "")
    o.add("-p", "Usage 2 only. Directory of FASTA files to convert to "
          "binary format.", "")
    o.add("-f", "k-mer filter file (sorted by descending frequency).", "")
    o.add("-k", "[int], k-mer size used for MinHashing.", 16)
    o.add("--num-hashes", "[int], Number of min-mers for MinHashing.", 512)
    o.add("--threshold", "[double], Second-stage identity cutoff.", 0.78)
    o.add("--filter-threshold", "[double], filter-file repetitive cutoff.",
          1.0e-5)
    o.add("--max-shift", "[double], valid match region around the "
          "estimated overlap.", 0.2)
    o.add("--num-min-matches", "[int], min shared min-mers before stage "
          "2.", 3)
    o.add("--num-threads", "[int], host worker threads.",
          os.cpu_count() or 1)
    o.add("--repeat-weight", "[double] tf-idf repeat suppression "
          "strength.", 0.9)
    o.add("--repeat-idf-scale", "[double] upper idf scale bound.", 3.0)
    o.add("--ordered-kmer-size", "[int] second-stage k-mer size.", 12)
    o.add("--ordered-sketch-size", "[int] second-stage sketch size.", 1536)
    o.add("--min-store-length", "[int], min read length stored in box.", 0)
    o.add("--min-olap-length", "[int], min read length overlapped.", 116)
    o.add("--no-self", "Skip overlaps inside the box.", False)
    o.add("--store-full-id", "Store full FASTA ids (first token).", False)
    o.add("--supress-noise", "[int] 0) off 1) drop non-filter k-mers "
          "2) suppress non-filter k-mers.", 0)
    o.add("--no-tf", "Disable tf in tf-idf weighing.", False)
    o.add("--no-rc", "Do not use reverse complements.", False)
    o.add("--settings", "Presets for unset flags: 0) none 1) default "
          "2) fast 3) sensitive.", 0)
    o.add("--backend", "device (JAX pipeline on one device), sharded "
          "(all visible devices, SPMD over a mesh) or oracle (numpy "
          "reference).",
          "device")
    o.add("--paf", "Emit PAF instead of MHAP M4 output.", False)
    return o


def options_to_cfg(o: ParseOptions) -> dict:
    return dict(
        kmer_size=o.get("-k").value,
        num_hashes=o.get("--num-hashes").value,
        num_min_matches=o.get("--num-min-matches").value,
        threshold=o.get("--threshold").value,
        ordered_kmer_size=o.get("--ordered-kmer-size").value,
        ordered_sketch_size=o.get("--ordered-sketch-size").value,
        max_shift=o.get("--max-shift").value,
        min_store_length=o.get("--min-store-length").value,
        min_olap_length=o.get("--min-olap-length").value,
        repeat_weight=o.get("--repeat-weight").value,
    )


def load_filter(o: ParseOptions):
    path = o.get("-f").value
    if not path:
        return None
    from ..io.fasta import open_text
    from ..oracle.filter import FrequencyCounts

    rw = o.get("--repeat-weight").value
    offset = rw if 0.0 <= rw < 1.0 else 0.0
    t0 = time.time()
    print(f"Reading in filter file {path}.", file=sys.stderr)
    with open_text(path) as f:
        kf = FrequencyCounts(
            f, o.get("--filter-threshold").value, offset,
            o.get("--supress-noise").value, o.get("--no-tf").value,
            o.get("--repeat-idf-scale").value,
            not o.get("--no-rc").value,
            # reference semantics: suppress-noise modes store file k-mers
            # in a guava BloomFilter (FrequencyCounts.java:137); the
            # guava-compatible reimplementation keeps runs jar-comparable
            use_bloom=True)
    print(f"Time (s) to read filter file: {time.time() - t0}",
          file=sys.stderr)
    return kf


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    o = build_options()
    if not o.process(argv):
        return 0

    st = o.get("--settings").value
    if st < 0 or st > 3:
        print("Please enter valid --settings flag. See options below:")
        print(o.help_menu())
        return 1
    if st in PRESETS:
        for name, val in PRESETS[st].items():
            if not o.get(name).is_set:
                o.get(name).value = val

    s_file = o.get("-s").value
    p_file = o.get("-p").value
    q_file = o.get("-q").value
    if not s_file and not p_file:
        print("Please set the -s or the -p options. See options below:")
        print(o.help_menu())
        return 1
    if p_file and not q_file:
        print("Please set the -q option. See options below:")
        print(o.help_menu())
        return 1
    for flag in ("-p", "-s", "-q", "-f"):
        v = o.get(flag).value
        if v and not os.path.exists(v):
            print(f"Could not find requested file/folder: {v}")
            return 1
    checks = [
        (o.get("--num-threads").value <= 0,
         "Number of threads must be positive."),
        (o.get("-k").value <= 0, "k-mer size must be positive."),
        (o.get("--num-min-matches").value <= 0,
         "Minimum number of matches must be positive."),
        (o.get("--min-store-length").value < 0,
         "The minimum read length stored must be >=0."),
        (o.get("--repeat-idf-scale").value < 1.0,
         "The minimum repeat idf scale must be >=1.0."),
        (o.get("--max-shift").value < -1.0,
         "The minimum shift must be greater than -1."),
        (not 0.0 <= o.get("--threshold").value <= 1.0,
         "The second stage filter threshold must be 0<=threshold<=1.0."),
        (not 0 <= o.get("--supress-noise").value <= 2,
         "The --supress-noise parameter must be in [0,2]."),
    ]
    for bad, msg in checks:
        if bad:
            print(msg)
            return 1

    print("Running with these settings:", file=sys.stderr)
    print(o, file=sys.stderr)

    if o.get("--backend").value in ("device", "sharded"):
        from ..utils.compile_cache import enable_compile_cache

        enable_compile_cache()

    cfg = options_to_cfg(o)
    kmer_filter = load_filter(o)
    store_full_id = o.get("--store-full-id").value
    do_rc = not o.get("--no-rc").value
    backend = o.get("--backend").value
    t_total = time.time()

    if p_file:
        run_precompute(o, cfg, kmer_filter, store_full_id, do_rc, backend)
        print(f"Total time (s): {time.time() - t_total}", file=sys.stderr)
        return 0

    run_overlap(o, cfg, kmer_filter, store_full_id, do_rc, backend)
    print(f"Total time (s): {time.time() - t_total}", file=sys.stderr)
    return 0


def _load_reads(path: str, store_full_id: bool):
    from ..io.fasta import read_sequences

    headers, reads = [], []
    for h, s in read_sequences(path, store_full_id):
        headers.append(h)
        reads.append(s)
    return headers if store_full_id else None, reads


def _get_overlapper(cfg, backend, kmer_filter, num_threads=None):
    from ..pipeline.overlapper import TpuOverlapper

    if backend not in ("device", "sharded"):
        return None
    vf = None
    if kmer_filter is not None:
        from ..pipeline.freqfilter import VectorFrequencyFilter

        vf = VectorFrequencyFilter(kmer_filter)
    if backend == "sharded":
        from ..parallel.sharded import ShardedOverlapper, make_mesh

        ov = ShardedOverlapper(make_mesh(), cfg, kmer_filter=vf)
    else:
        ov = TpuOverlapper(cfg, kmer_filter=vf)
    if num_threads:
        # host-side pools (numpy BLAS-free paths are single-threaded; the
        # thread count governs host helpers like batched SW adjudication)
        ov.num_threads = int(num_threads)
        os.environ.setdefault("OMP_NUM_THREADS", str(num_threads))
    return ov


def run_overlap(o, cfg, kmer_filter, store_full_id, do_rc, backend):
    from ..io import datstore
    from ..io.fasta import list_sequence_files
    from ..oracle import pipeline as oracle_pipeline

    from ..io.formats import write_lines

    s_file = o.get("-s").value
    q_file = o.get("-q").value
    no_self = o.get("--no-self").value
    paf = o.get("--paf").value
    ov = _get_overlapper(cfg, backend, kmer_filter,
                         o.get("--num-threads").value)

    t0 = time.time()
    print("Processing files for storage in reverse index...",
          file=sys.stderr)
    if s_file.endswith(".dat"):
        box = datstore.read_dat(s_file, 0,
                                sketch_size=cfg["ordered_sketch_size"])
        if ov is None:
            raise SystemExit(".dat input requires the device backend")
    else:
        headers, reads = _load_reads(s_file, store_full_id)
        if ov is not None:
            box = ov.sketch_reads(reads, headers, do_rc=do_rc)
        else:
            box = oracle_pipeline.sketch_all(
                reads, dict(cfg), kmer_filter, headers, do_rc=do_rc)
    n_box = box.n_real if hasattr(box, 'n_real') else len(box)
    print(f"Processed {n_box} unique sequences (fwd and rev).",
          file=sys.stderr)
    print(f"Time (s) to read and hash from file: {time.time() - t0}",
          file=sys.stderr)

    out = sys.stdout
    lines_count = 0
    if ov is not None:
        import numpy as np

        postings = ov._build_index(box)
        if not no_self or not q_file:
            t0 = time.time()
            q_sel = np.nonzero(box.is_fwd)[0]
            lines = sorted(ov._find_matches(box, postings, box, q_sel, True))
            lines_count += write_lines(lines, out, paf)
            print(f"Time (s) to score and output to self: {time.time() - t0}",
                  file=sys.stderr)
        offset = n_box // 2
        if q_file:
            for qf in list_sequence_files(q_file):
                t0 = time.time()
                if qf.endswith(".dat"):
                    queries = datstore.read_dat(
                        qf, offset, fwd_only=True,
                        sketch_size=cfg["ordered_sketch_size"])
                else:
                    qh, qreads = _load_reads(qf, store_full_id)
                    queries = ov.sketch_reads(qreads, qh, offset=offset,
                                              do_rc=False)
                q_sel = np.arange(len(queries))
                lines = sorted(ov._find_matches(box, postings, queries,
                                                q_sel, False))
                lines_count += write_lines(lines, out, paf)
                offset += len(queries)
                print(f"Processed {len(queries)} to sequences.",
                      file=sys.stderr)
                print(f"Time (s) to score, hash to-file, and output: "
                      f"{time.time() - t0}", file=sys.stderr)
    else:
        index = oracle_pipeline.OracleIndex(dict(cfg))
        for sk in box:
            index.add(sk)
        if not no_self or not q_file:
            lines = []
            for sk in box:
                if sk.is_fwd:
                    lines.extend(index.find_matches(sk, to_self=True))
            lines_count += write_lines(sorted(lines), out, paf)
        offset = (box.n_real if hasattr(box, 'n_real') else len(box)) // 2
        if q_file:
            for qf in list_sequence_files(q_file):
                qh, qreads = _load_reads(qf, store_full_id)
                queries = oracle_pipeline.sketch_all(
                    qreads, dict(cfg), kmer_filter, qh, offset=offset,
                    do_rc=False)
                lines = []
                for sk in queries:
                    lines.extend(index.find_matches(sk, to_self=False))
                lines_count += write_lines(sorted(lines), out, paf)
                offset += len(queries)
    out.flush()
    # final stats block, field-for-field with MhapMain.outputFinalStat
    # (:572-590): same lines, same denominators (size() = number of stored
    # sketches incl. reverse complements; divisions print inf/nan on
    # zero-denominator runs exactly like Java doubles)
    if ov is not None:
        st = ov.stats
        size = box.n_real  # matchSearch.size(): stored sketch count
        searched = float(st["sequences_searched"])
        hit = float(st["sequences_hit"])
        compared = float(st["sequences_fully_compared"])
        matches = float(st["matches_processed"])

        def jdiv(a, b):
            if b == 0.0:
                return float("nan") if a == 0.0 else float("inf")
            return a / b

        print("MinHash search time (s): "
              f"{st['minhash_search_time']}", file=sys.stderr)
        print(f"Total matches found: {st['matches_processed']}",
              file=sys.stderr)
        print("Average number of matches per lookup: "
              f"{jdiv(matches, searched)}", file=sys.stderr)
        print("Average number of table elements processed per lookup: "
              f"{jdiv(st['elements_processed'], searched)}", file=sys.stderr)
        print("Average number of table elements processed per match: "
              f"{jdiv(st['elements_processed'], matches)}", file=sys.stderr)
        print("Average % of hashed sequences hit per lookup: "
              f"{jdiv(hit, size * searched) * 100.0}", file=sys.stderr)
        print("Average % of hashed sequences hit that are matches: "
              f"{jdiv(matches, hit) * 100.0}", file=sys.stderr)
        print("Average % of hashed sequences fully compared that are "
              f"matches: {jdiv(matches, compared) * 100.0}",
              file=sys.stderr)
        if ov.slow_pair_count:
            print(f"Exact-automaton fallback pairs: {ov.slow_pair_count}",
                  file=sys.stderr)
    else:
        print(f"Total matches found: {lines_count}", file=sys.stderr)


def run_precompute(o, cfg, kmer_filter, store_full_id, do_rc, backend):
    from ..io import datstore
    from ..io.fasta import list_sequence_files

    p_file = o.get("-p").value
    to_dir = o.get("-q").value
    if not os.path.isdir(to_dir):
        raise SystemExit("Target directory doesn't exit.")
    print("Processing FASTA files for binary compression...",
          file=sys.stderr)
    ov = _get_overlapper(cfg, backend, kmer_filter)
    for pf in list_sequence_files(p_file):
        t0 = time.time()
        headers, reads = _load_reads(pf, store_full_id)
        if ov is not None:
            store = ov.sketch_reads(reads, headers, do_rc=do_rc)
        else:
            raise SystemExit("-p requires the device backend")
        name = os.path.basename(pf)
        i = name.rfind(".")
        if i > 0:
            name = name[:i]
        out_path = os.path.join(to_dir, name + ".dat")
        datstore.write_dat(out_path, store,
                           ordered_kmer_size=cfg["ordered_kmer_size"])
        print(f"Processed {len(store)} sequences (fwd and rev).",
              file=sys.stderr)
        print(f"Read, hashed, and stored file {pf} to {out_path}.",
              file=sys.stderr)
        print(f"Time (s): {time.time() - t0}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
