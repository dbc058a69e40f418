"""``plot`` stage: heatmap / pairwise scatter / minor-allele line plots
(counterpart of tracs_tpu/stages/plots.py; host only, no ``--device``).

The same flat-array design as tracs_tpu's: each sample's frequencies are
one stacked ``[L_total, 4]`` matrix (contigs concatenated), site selections
are boolean masks over it, and the long-format tables come in one shot from
``np.nonzero`` of the final mask, ordered (contig, allele, position) as the
reference's melt loop emits them.  Without pandas: a table is a dict of
equal-length numpy columns (``_concat``, ``_take``), and ``_write_csv``
writes the bytes pandas' ``to_csv(index=False)`` writes for the same columns
(shortest round-trip floats, ``True``/``False``, minimal quoting, ``\\n``
line ends).  The heatmap reads its distance CSV with the ``csv`` module:
sample names stay text (pandas would read names that look numeric as
numbers, which only changes the order of the PNG's tick labels).

The scatter's interactive HTML is the plotly figure JSON embedded beside a
plotly.js script tag, with no plotly package; the static PNG is always
written too (tracs_tpu skips it when ``TRACS_TPU_SCATTER_PNG=0``; the port
reads no environment variable).  matplotlib is imported inside the
functions that draw, never when this module is imported: without it
``plot`` exits non-zero naming the package, and every other subcommand runs.
"""

from __future__ import annotations

import argparse
import csv
import gzip
import json
import logging
import os

import numpy as np
from scipy.cluster.hierarchy import leaves_list, linkage

_ALLELES = np.array(list("ACGT"))
_ALLELE_COLORS = {"A": "#e41a1c", "C": "#377eb8", "G": "#4daf4a", "T": "#984ea3"}

#: pinned plotly.js — any 2.x renders the scatter/scattergl traces below
_PLOTLY_JS_CDN = "https://cdn.plot.ly/plotly-2.35.2.min.js"


def plots_parser(parser):
    parser.description = "Generates plots from a pileup file."

    io_opts = parser.add_argument_group("Input/output")
    io_opts.add_argument(
        "-i", "--input", dest="input_files", required=True,
        help="input file(s): a distance csv (heatmap) or two pileups "
             "(scatter/line)",
        type=os.path.abspath, nargs="+",
    )
    io_opts.add_argument(
        "-p", "--prefix", dest="output_file", required=True,
        help="prefix of output file", type=os.path.abspath,
    )
    io_opts.add_argument(
        "--type", dest="plot_type", required=True,
        help="Type of plot (scatter, line, heatmap)",
        choices=["scatter", "line", "heatmap"], type=str,
    )

    pileup = parser.add_argument_group("Pileup options")
    pileup.add_argument("--min-freq", dest="min_freq", type=float, default=0.0,
                        help="minimum frequency to include a variant (default=0.0)")
    pileup.add_argument("--either-strand", dest="require_both_strands",
                        action="store_false", default=True,
                        help="turns off the requirement that a variant is supported by "
                             "both strands")
    pileup.add_argument("--contigs", dest="contigs", default=["All"], type=str,
                        nargs="+", help="contigs for plotting (default=All)")

    distance = parser.add_argument_group("Transmission distance options")
    distance.add_argument("--column-name", dest="column_name", type=str,
                          default="SNP distance",
                          help="Column name in distance matrix to use "
                               "(default='SNP distance')")
    distance.add_argument("--threshold", dest="threshold", type=float, default=None,
                          help="threshold to filter transmission distances (default=None)")

    plot = parser.add_argument_group("Plot options")
    plot.add_argument("--alpha", dest="alpha", type=float, default=0.1,
                      help="alpha value for plotting (default=0.1)")
    plot.add_argument("--height", dest="height", type=float, default=7,
                      help="height value for plotting (default=7)")
    plot.add_argument("--width", dest="width", type=float, default=10,
                      help="width value for plotting (default=10)")

    parser.set_defaults(func=plots)
    return parser


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported at the first drawing.
    Raises ModuleNotFoundError naming matplotlib when it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ModuleNotFoundError(
            "the plot stage draws with matplotlib, which is not installed here "
            "(pip install matplotlib)", name="matplotlib") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def open_file(file_path):
    if file_path.endswith(".gz"):
        return gzip.open(file_path, "rt")
    return open(file_path, "r")


def _sample_label(path: str) -> str:
    return os.path.basename(path).replace(".txt.gz", "")


# ---------------------------------------------------------------------------
# tables: dicts of equal-length numpy columns
# ---------------------------------------------------------------------------


def _n_rows(table: dict) -> int:
    return len(next(iter(table.values())))


def _concat(tables: list[dict]) -> dict:
    return {k: np.concatenate([t[k] for t in tables]) for k in tables[0]}


def _take(table: dict, rows) -> dict:
    return {k: v[rows] for k, v in table.items()}


def _cell(value) -> str:
    """A value as pandas' ``to_csv`` writes it."""
    if isinstance(value, (bool, np.bool_)):
        return "True" if value else "False"
    if isinstance(value, (float, np.floating)):
        return repr(float(value))
    return str(value)


def _write_csv(table: dict, path: str) -> None:
    """The bytes of ``pandas.DataFrame(table).to_csv(path, index=False)``."""
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(list(table))
        for row in zip(*table.values()):
            writer.writerow([_cell(v) for v in row])


# ---------------------------------------------------------------------------
# heatmap
# ---------------------------------------------------------------------------


def _number(text: str) -> float:
    try:
        return float(text)
    except ValueError:
        return np.nan  # NA and the other empty markers


def _read_distance_csv(path: str, columns) -> dict:
    """The named columns of a headered distance CSV: ``sampleA`` and
    ``sampleB`` as text, the others as floats (NA as NaN)."""
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        rows = [row for row in reader if row]
    out = {}
    for name in columns:
        k = header.index(name)
        vals = [row[k] for row in rows]
        out[name] = (np.array(vals, dtype=object) if name in ("sampleA", "sampleB")
                     else np.array([_number(v) for v in vals], dtype=float))
    return out


def _symmetric_distance_matrix(table: dict, names: list[str]) -> np.ndarray:
    """[n, n] float matrix of the 'SNP distance' column over ``names``.

    Direct (A, B) entries win; missing cells fall back to the transposed
    (B, A) entry; cells present in neither direction stay NaN.  (The value
    column is always 'SNP distance' regardless of the threshold column —
    a reference quirk preserved from plots.py:142.)
    """
    code = {s: i for i, s in enumerate(names)}
    n = len(names)
    mat = np.full((n, n), np.nan)
    ia = np.array([code[s] for s in table["sampleA"]], dtype=np.int64)
    ib = np.array([code[s] for s in table["sampleB"]], dtype=np.int64)
    mat[ia, ib] = table["SNP distance"]
    mirrored = mat.T.copy()
    take = np.isnan(mat) & ~np.isnan(mirrored)
    mat[take] = mirrored[take]
    return mat


def _single_linkage_order(mat: np.ndarray) -> np.ndarray:
    """Leaf order from single-linkage over the matrix ROWS as observation
    vectors, with NaN (never-compared) cells pushed far away — the same
    ordering recipe the reference uses for its heatmap axes."""
    far = np.nanmax(mat) + 100
    filled = np.where(np.isnan(mat), far, mat)
    return leaves_list(linkage(filled, method="single"))


def plot_heatmap(distance_file, outfile, column="SNP distance", threshold=None,
                 height=7, width=10):
    plt = _pyplot()
    table = _read_distance_csv(distance_file, dict.fromkeys(
        ["sampleA", "sampleB", "SNP distance", column]))
    if threshold is not None:
        table = _take(table, table[column] <= threshold)

    names = sorted(set(table["sampleA"]).union(table["sampleB"]))
    mat = _symmetric_distance_matrix(table, names)
    order = _single_linkage_order(mat)
    labels = [names[i] for i in order]

    fig, ax = plt.subplots(figsize=(width, height))
    img = ax.matshow(mat[np.ix_(order, order)], cmap="viridis")
    fig.colorbar(img).set_label(column)
    ax.set_xticks(range(len(labels)), labels, rotation=90)
    ax.set_yticks(range(len(labels)), labels)
    plt.title("Heatmap of " + column)
    plt.savefig(outfile + ".png", dpi=300, bbox_inches="tight")
    plt.close(fig)


# ---------------------------------------------------------------------------
# pileup frequencies (shared by scatter + line)
# ---------------------------------------------------------------------------


def read_pileup(inputfile, contig_length, require_both_strands=True, keep_contigs="All"):
    """Per-contig [L, 4] allele-frequency matrices: per-site A/C/G/T counts
    normalised by max(1, site depth); uncovered sites stay all-zero; non-ACGT
    alleles or reference bases contribute nothing (reference
    plots.py:182-212), parsed by the shared pileup reader (io/pileup.py)."""
    from tracs_tpu_torch.io.pileup import parse_pileup

    wanted = {
        c: int(n) for c, n in contig_length.items()
        if ("All" in keep_contigs) or (c in keep_contigs)
    }
    counts = parse_pileup(inputfile, wanted, require_both_strands)
    freqs = counts / np.maximum(1.0, counts.sum(axis=1, keepdims=True))
    split_at = np.cumsum([n for n in wanted.values()])[:-1]
    return dict(zip(wanted, np.split(freqs, split_at)))


def _contig_lengths(count_file_A, count_file_B, keep_contigs):
    """Union of contig -> max position over both pileups, in order of first
    appearance (file A's contigs first).  Raises when the files share no
    contig names (reference plots.py:244-246)."""
    per_file = []
    for path in (count_file_A, count_file_B):
        lengths: dict[str, int] = {}
        with open_file(path) as fh:
            for line in fh:
                fields = line.split(maxsplit=2)
                contig = fields[0]
                if ("All" in keep_contigs) or (contig in keep_contigs):
                    pos = int(fields[1])
                    if lengths.get(contig, 0) < pos:
                        lengths[contig] = pos
        per_file.append(lengths)

    la, lb = per_file
    if not set(la) & set(lb):
        raise ValueError("No contig names match!")
    merged = {c: max(n, lb.get(c, 0)) for c, n in la.items()}
    merged.update({c: n for c, n in lb.items() if c not in la})
    return merged


class _Stacked:
    """Contig-stacked view of a read_pileup result: one [L_total, 4]
    frequency matrix plus the bookkeeping to label rows by contig and
    local position.  All site selections below are vectorised over this."""

    def __init__(self, freqs_by_contig: dict[str, np.ndarray]):
        self.contigs = list(freqs_by_contig)
        sizes = [freqs_by_contig[c].shape[0] for c in self.contigs]
        self.freq = (
            np.concatenate([freqs_by_contig[c] for c in self.contigs])
            if self.contigs else np.zeros((0, 4))
        )
        self.starts = np.concatenate([[0], np.cumsum(sizes)])[:-1]
        # contig index and 0-based local position of every stacked row
        self.contig_idx = np.repeat(np.arange(len(sizes)), sizes)
        self.local_pos = np.arange(self.freq.shape[0]) - self.starts[self.contig_idx]


def _long_frame(st: _Stacked, keep: np.ndarray, sample_label: str,
                positions: np.ndarray | None = None):
    """(columns, site, allele) of the long-format rows selected by the
    [L, 4] boolean ``keep`` mask, ordered (contig, allele, position) — the
    order the reference's per-contig melt loop emits.  ``positions``
    overrides the 0-based position vector (the line plot numbers positions
    within its selected-site subset)."""
    pos = st.local_pos if positions is None else positions
    site, allele = np.nonzero(keep)
    order = np.lexsort((pos[site], allele, st.contig_idx[site]))
    site, allele = site[order], allele[order]
    cols = {
        "position": pos[site] + 1,
        "allele": _ALLELES[allele],
        "frequency": st.freq[site, allele],
        "sample": np.repeat(sample_label, len(site)),
        "contig": np.asarray(st.contigs, dtype=object)[st.contig_idx[site]],
    }
    return cols, site, allele


# ---------------------------------------------------------------------------
# scatter
# ---------------------------------------------------------------------------


def _pairwise_frame(count_file_A, count_file_B, fA, fB, min_freq):
    """Long-format site/allele table for the pairwise scatter (columns
    position, allmismatch, variable, allele, frequency, match, sample,
    contig), or None when no row is selected.

    Selection semantics (value-parity with reference plots.py:262-334):
      * ``match``        — allele present (>0) in both samples at the site;
      * ``allmismatch``  — both samples covered but NO shared allele;
      * ``variable``     — >1 allele with summed frequency above min_freq;
      * rows need frequency >= min_freq AND (frequency <= 1-min_freq OR
        variable OR allmismatch) — fixed near-1.0 calls shared by both
        samples are uninformative and dropped.
    Rows come out (sample, contig, allele, position)-ordered.
    """
    sa, sb = _Stacked(fA), _Stacked(fB)
    present_a, present_b = sa.freq > 0, sb.freq > 0
    match = present_a & present_b                                   # [L, 4]
    covered = present_a.any(axis=1) & present_b.any(axis=1)         # [L]
    allmismatch = covered & ~match.any(axis=1)
    variable = ((sa.freq + sb.freq) > min_freq).sum(axis=1) > 1

    frames = []
    for st, path in ((sa, count_file_A), (sb, count_file_B)):
        keep = (st.freq >= min_freq) & (
            (st.freq <= 1 - min_freq) | variable[:, None] | allmismatch[:, None]
        )
        cols, site, allele = _long_frame(st, keep, _sample_label(path))
        frames.append({
            "position": cols["position"],
            "allmismatch": allmismatch[site],
            "variable": variable[site],
            "allele": cols["allele"],
            "frequency": cols["frequency"],
            "match": match[site, allele],
            "sample": cols["sample"],
            "contig": cols["contig"],
        })
    table = _concat(frames)
    return table if _n_rows(table) else None


def plot_pairwise_scatter(count_file_A, count_file_B, outfile,
                          require_both_strands=True, min_freq=0.01,
                          keep_contigs="All"):
    logging.info("Counting entries in pileup files...")
    contig_length = _contig_lengths(count_file_A, count_file_B, keep_contigs)

    logging.info("Generating frequency matrices...")
    fA = read_pileup(count_file_A, contig_length, require_both_strands, keep_contigs)
    fB = read_pileup(count_file_B, contig_length, require_both_strands, keep_contigs)

    logging.info("Computing pairwise comparisons...")
    table = _pairwise_frame(count_file_A, count_file_B, fA, fB, min_freq)
    if table is None:
        logging.warning("Nothing to plot!")
        return
    _write_csv(table, outfile + ".csv")
    # the interactive HTML always (as the reference's plotly scatter), and
    # the static PNG for hosts that cannot fetch plotly.js
    _scatter_html(table, outfile)
    _scatter_png(table, outfile)


def _first_seen(values) -> list:
    return list(dict.fromkeys(values))


def _scatter_fig_json(table):
    """Plotly figure dict for the pairwise scatter: a (sample-row x
    contig-column) facet grid, alleles colored, matching alleles filled /
    non-matching open — the same visual contract as the reference's
    ``px.scatter(..., facet_col='contig', facet_row='sample',
    color='allele', symbol='match')`` (reference tracs/plots.py:303-322)."""
    samples = _first_seen(table["sample"])
    contigs = _first_seen(table["contig"])
    nrow, ncol = len(samples), len(contigs)
    data = []
    layout = {
        "grid": {"rows": nrow, "columns": ncol, "pattern": "independent"},
        "legend": {"title": {"text": "allele / match"}},
        "margin": {"t": 40},
    }
    seen_legend = set()
    for si, sample in enumerate(samples):
        for ci, contig in enumerate(contigs):
            idx = si * ncol + ci + 1
            ax = "" if idx == 1 else str(idx)
            in_panel = (table["sample"] == sample) & (table["contig"] == contig)
            for allele, color in _ALLELE_COLORS.items():
                for is_match, symbol in ((True, "circle"), (False, "circle-open")):
                    rows = in_panel & (table["allele"] == allele) & (table["match"] == is_match)
                    if not rows.any():
                        continue
                    name = f"{allele} ({'match' if is_match else 'mismatch'})"
                    trace = {
                        "type": "scattergl",
                        "mode": "markers",
                        "x": table["position"][rows].tolist(),
                        # Python floats, as a pandas column iterates
                        "y": [round(v, 6) for v in table["frequency"][rows].tolist()],
                        "xaxis": "x" + ax,
                        "yaxis": "y" + ax,
                        "name": name,
                        "legendgroup": name,
                        "showlegend": name not in seen_legend,
                        "marker": {
                            "color": color, "symbol": symbol,
                            "opacity": 0.7, "size": 6,
                        },
                        "hovertemplate": (
                            f"{sample} / {contig}<br>allele={allele} "
                            f"match={is_match}<br>position=%{{x}}"
                            f"<br>frequency=%{{y}}<extra></extra>"
                        ),
                    }
                    seen_legend.add(name)
                    data.append(trace)
            layout["xaxis" + ax] = {"title": {"text": f"position ({contig})"}}
            layout["yaxis" + ax] = {
                "title": {"text": f"frequency<br>{sample}"} if ci == 0 else {},
                "range": [-0.05, 1.05],
            }
    return {"data": data, "layout": layout}


def _scatter_html(table, outfile):
    """Write ``outfile``.html: the figure JSON embedded in the page, the
    plotly.js LIBRARY loaded from its CDN script tag (like plotly's own
    'cdn' include mode).  The data needs no further fetch; the
    interactive render needs that one script, so the PNG covers offline
    viewing."""
    fig = _scatter_fig_json(table)
    html = (
        "<!DOCTYPE html>\n<html><head><meta charset=\"utf-8\">\n"
        "<title>tracs-tpu pairwise scatter</title>\n"
        f"<script src=\"{_PLOTLY_JS_CDN}\" charset=\"utf-8\"></script>\n"
        "</head><body>\n"
        "<div id=\"tracs-scatter\" style=\"width:100%;height:96vh;\"></div>\n"
        "<script>\nconst fig = "
        + json.dumps(fig, separators=(",", ":"))
        + ";\nPlotly.newPlot(\"tracs-scatter\", fig.data, fig.layout,"
        " {responsive: true});\n</script>\n</body></html>\n"
    )
    with open(outfile + ".html", "w") as fh:
        fh.write(html)
    logging.info("wrote interactive scatter: %s.html", outfile)


def _scatter_png(table, outfile):
    """Static scatter: one panel per (sample, contig), filled markers for
    matching alleles, open markers otherwise."""
    plt = _pyplot()
    samples = _first_seen(table["sample"])
    contigs = _first_seen(table["contig"])
    fig, axes = plt.subplots(
        len(samples), len(contigs), figsize=(10, 7), squeeze=False, sharey=True
    )
    for si, sample in enumerate(samples):
        for ci, contig in enumerate(contigs):
            in_panel = (table["sample"] == sample) & (table["contig"] == contig)
            ax = axes[si][ci]
            for allele, color in _ALLELE_COLORS.items():
                rows = in_panel & (table["allele"] == allele)
                hit, miss = rows & table["match"], rows & ~table["match"]
                ax.scatter(table["position"][hit], table["frequency"][hit], s=8,
                           color=color, alpha=0.7, label=allele)
                ax.scatter(table["position"][miss], table["frequency"][miss], s=8,
                           facecolors="none", edgecolors=color, alpha=0.7)
            ax.set_ylim(-0.05, 1.05)
            ax.set_title(f"{sample} / {contig}", fontsize=8)
    axes[0][0].legend(fontsize=6)
    plt.savefig(outfile + ".png", dpi=300, bbox_inches="tight")
    plt.close(fig)


# ---------------------------------------------------------------------------
# line
# ---------------------------------------------------------------------------


def _line_frame(count_file_A, count_file_B, sa: _Stacked, sb: _Stacked, min_freq):
    """The line plot's table (columns position, allele, frequency, sample,
    contig, sample_code), before the singleton drop."""
    diff = sa.freq.argmax(axis=1) != sb.freq.argmax(axis=1)  # [L]
    # subset-local position per site: rank among selected sites of the
    # same contig (only meaningful where diff holds)
    rank_all = np.cumsum(diff) - 1
    first_of_contig = np.zeros(len(diff), dtype=np.int64)
    for c in range(len(sa.contigs)):
        rows = sa.contig_idx == c
        sel = diff & rows
        first_of_contig[rows] = rank_all[sel][0] if sel.any() else 0
    subset_pos = rank_all - first_of_contig

    frames = []
    for st, path, code in ((sa, count_file_A, 1), (sb, count_file_B, 0)):
        band = (st.freq >= min_freq) & (st.freq <= 1 - min_freq)
        cols, _, _ = _long_frame(st, band & diff[:, None], _sample_label(path),
                                 positions=subset_pos)
        cols["sample_code"] = np.repeat(code, len(cols["position"]))
        frames.append(cols)
    return _concat(frames)


def _paired_rows(table) -> np.ndarray:
    """Mask of the rows whose (allele, contig, position) key appears more
    than once in the table (reference: a MultiIndex of the three columns,
    ``value_counts() > 1``): the line segments, one endpoint per sample."""
    keys = list(zip(table["allele"], table["contig"], table["position"].tolist()))
    counts: dict = {}
    for k in keys:
        counts[k] = counts.get(k, 0) + 1
    return np.array([counts[k] > 1 for k in keys], dtype=bool)


def plot_pairwise_line(count_file_A, count_file_B, outfile, keep_contigs="All",
                       require_both_strands=True, min_freq=0.01, alpha=0.1,
                       height=7, width=10):
    """Minor-allele frequency shift lines at consensus-differing sites.

    Site selection (value-parity with reference plots.py:336-455): keep
    sites whose argmax allele differs between the samples, then alleles
    with frequency inside [min_freq, 1-min_freq], then drop (allele,
    contig, position) singletons so every drawn line has both endpoints.
    The CSV's ``position`` column numbers sites WITHIN the selected
    subset, 1-based — a reference quirk (its per-contig DataFrame is
    built from the boolean-indexed subset, so reset_index renumbers).
    """
    logging.info("Counting entries in pileup files...")
    contig_length = _contig_lengths(count_file_A, count_file_B, keep_contigs)

    logging.info("Generating frequency matrices...")
    fA = read_pileup(count_file_A, contig_length, require_both_strands, keep_contigs)
    fB = read_pileup(count_file_B, contig_length, require_both_strands, keep_contigs)

    table = _line_frame(count_file_A, count_file_B, _Stacked(fA), _Stacked(fB), min_freq)
    if not _n_rows(table):
        logging.warning("Nothing to plot!")
        return
    table = _take(table, _paired_rows(table))

    # one segment per (allele, contig, position) group, in sorted key order,
    # its endpoints in table order
    groups: dict = {}
    for r, k in enumerate(zip(table["allele"], table["contig"], table["position"].tolist())):
        groups.setdefault(k, []).append(r)
    segs = [np.column_stack([table["sample_code"][rows], table["frequency"][rows]])
            for _k, rows in sorted(groups.items())]
    plt = _pyplot()
    from matplotlib.collections import LineCollection

    fig, ax = plt.subplots(figsize=(width, height))
    ax.add_collection(LineCollection(segs, linewidths=0.5, alpha=alpha))
    ax.set_xticks([0, 1])
    ax.set_xticklabels(
        [os.path.basename(p).split(".")[0] for p in (count_file_A, count_file_B)],
        rotation=90,
    )
    ax.set_xlabel("Sample")
    ax.set_ylabel("Frequency")
    ax.set_title("Minor allele frequency by sample")
    plt.savefig(outfile + ".png", dpi=300, bbox_inches="tight")
    plt.close(fig)
    _write_csv(table, outfile + ".csv")


def plots(args):
    logging.basicConfig(
        format="%(asctime)s - %(message)s", datefmt="%d-%b-%y %H:%M:%S",
        level=logging.INFO,
    )
    try:
        if args.plot_type == "scatter":
            plot_pairwise_scatter(
                args.input_files[0], args.input_files[1], args.output_file,
                require_both_strands=args.require_both_strands,
                min_freq=args.min_freq, keep_contigs=args.contigs,
            )
        elif args.plot_type == "line":
            plot_pairwise_line(
                args.input_files[0], args.input_files[1], args.output_file,
                require_both_strands=args.require_both_strands,
                min_freq=args.min_freq, keep_contigs=args.contigs,
                alpha=args.alpha, height=args.height, width=args.width,
            )
        elif args.plot_type == "heatmap":
            plot_heatmap(
                args.input_files[0], args.output_file, column=args.column_name,
                threshold=args.threshold, height=args.height, width=args.width,
            )
    except ModuleNotFoundError as e:
        if e.name != "matplotlib":
            raise
        raise SystemExit(f"tracs-tpu-torch plot: {e}") from e


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser = plots_parser(parser)
    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
