"""The comparisons with the plain reference that decide ``correct``."""

from __future__ import annotations

from benchmarks.harness import compare, generate


def demix_gap(run, picks: list, control: bool = False, detail: dict | None = None) -> float:
    """``stem_rel_l1`` of the system's stems of ``picks`` ((track, shift
    seed, stems) triples) against the reference's, worked out from the
    seed's weights and the raw tracks; with ``control`` the reference
    computed with TF32 products stands in the system's place.  ``detail``,
    a dict, gets each track's :func:`compare.gap_profile`."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = run.cell.config
    ref_mod = run.cell.reference()
    sd = generate.state_dicts(cfg, run.seed, run.device)
    tracks, seeds = [p[0] for p in picks], [p[1] for p in picks]
    ref = ref_mod.demix(sd, tracks, seeds, cfg, run.device)
    cand = (ref_mod.demix(sd, tracks, seeds, cfg, run.device, products="tf32") if control
            else [p[2] for p in picks])
    if detail is not None:
        detail["tracks"] = [compare.gap_profile(c, r, cfg["sample_rate"]) for c, r in zip(cand, ref)]
    return compare.stem_rel_l1(cand, ref)
