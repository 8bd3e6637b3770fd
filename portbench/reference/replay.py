"""The reference's replay of a window and the comparison that decides
``correct``.

:func:`replay` runs the plain filter (``pose_ukf``) over the sampled
vehicles' own inputs, tick by tick: the predict, then each update of the
traffic mix that fires, in the mix's order (the program's), with the
measurement model the mix names (``models/<model>.py``): the control's
run. :func:`judge` replays in float64 beside what the program produced,
along the whole window from the same start: the program's per-tick outputs
and final state against the reference's (``track_*``, ``trace_rel``, each
update's NIS under the name of the program's output, ``final_*``), each
worst over the sample and as a median over the vehicles of each vehicle's
worst. Which of them a cell compares, and their limits, are in
``portbench/checks/<cell>.json``; :func:`tick_fields` says which per-tick
outputs those numbers read, and only those are recorded.

``gate_mismatch`` counts the decisions of gated updates that differ where
the reference's NIS lies outside ±``GATE_MARGIN`` of the threshold. Within
the margin float32 rounding can decide either way, so the reference follows
the program's decision there and counts it (``gate_followed``, reported).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import pose_ukf as ref
from .models import load as load_model

GATE_MARGIN = 0.01  # relative band about the χ² threshold
TRACK = ("position", "orientation", "velocity")


class Inputs(NamedTuple):
    """The sampled vehicles' inputs, as the program received them."""

    mu0: torch.Tensor  # (S, 54)
    cov0: torch.Tensor  # (53, 53)
    gyro: torch.Tensor  # (T, S, 3)
    streams: dict  # stream → (T_k, S, m)
    covs: dict  # stream → (m, m)
    constants: dict  # name → (S,)
    updates: list  # the mix's update entries, in the program's order
    dt: float


class Outputs(NamedTuple):
    """Per-tick outputs of the sampled vehicles, and the final state."""

    ticks: dict  # output field → (n, S, …); only the fields the numbers read
    mu: torch.Tensor  # (S, 54)
    cov: torch.Tensor  # (S, 53, 53)


def _gated(updates: list) -> list:
    return [u for u in updates if hasattr(load_model(u["model"]), "GATE")]


def tick_fields(numbers, updates: list) -> list:
    """The program's per-tick output fields that ``numbers`` read."""
    nis = {u["outputs"]["nis"] for u in updates if "nis" in u.get("outputs", {})}
    out = []
    for k in numbers:
        k = k.removesuffix("_median")
        if k.startswith("track_"):
            out += TRACK
        elif k == "trace_rel":
            out.append("cov_trace")
        elif k in nis:
            out.append(k)
        elif k == "gate_mismatch":
            out += [u["outputs"]["accepted"] for u in _gated(updates) if "accepted" in u.get("outputs", {})]
    return list(dict.fromkeys(out))


def all_numbers(updates: list) -> list:
    """Every number the judge can read for a mix."""
    return ["track_sigma", "trace_rel", "gate_mismatch"] + [u["outputs"]["nis"] for u in updates
                                                              if "nis" in u.get("outputs", {})]


def _fire(update: dict, j: int):
    if j % update["every"] != update["at"]:
        return None
    return j // update["every"]


def _tick(mu, cov, inp: Inputs, params: ref.Params, j: int, tol: float, deciders=None):
    """One tick at stream tick ``j``; returns (mu, cov, {stream: the
    update's result} of the updates that fired)."""
    rr = inp.gyro[j]
    mu, cov = ref.predict(mu, cov, rr, params, inp.dt, tol)
    fired = {}
    for u in inp.updates:
        k = _fire(u, j)
        if k is None:
            continue
        model = load_model(u["model"])
        aux = model.aux(mu, rr, params) if hasattr(model, "aux") else inp.constants.get(u.get("aux"))
        decide = (deciders or {}).get(u["stream"])
        res = ref.update(mu, cov, model, inp.streams[u["stream"]][k], inp.covs[u["stream"]], params, aux, decide)
        mu, cov = res.mu, res.cov
        fired[u["stream"]] = res
    return mu, cov, fired


def _cast(inp: Inputs, dtype) -> Inputs:
    c = lambda x: x.to(dtype)
    return inp._replace(mu0=c(inp.mu0), cov0=c(inp.cov0), gyro=c(inp.gyro),
                        streams={k: c(v) for k, v in inp.streams.items()},
                        covs={k: c(v) for k, v in inp.covs.items()},
                        constants={k: c(v) for k, v in inp.constants.items()})


def replay(inp: Inputs, params: ref.Params, ticks: int, dtype, tol: float) -> Outputs:
    """The plain filter in ``dtype`` over ``ticks`` ticks (stream ticks wrap
    around), making its own gate decisions, with every per-tick output the
    judge can read: the control's run."""
    inp = _cast(inp, dtype)
    s = inp.mu0.shape[0]
    mu, cov = inp.mu0, inp.cov0.expand(s, ref.N, ref.N)
    nis = {u["stream"]: u["outputs"]["nis"] for u in inp.updates if "nis" in u.get("outputs", {})}
    acc = {u["stream"]: u["outputs"]["accepted"] for u in inp.updates if "accepted" in u.get("outputs", {})}
    rows = {k: [] for k in (*TRACK, "cov_trace", *nis.values(), *acc.values())}
    zero = torch.zeros(s, dtype=dtype, device=inp.gyro.device)
    period = inp.gyro.shape[0]
    for g in range(ticks):
        mu, cov, fired = _tick(mu, cov, inp, params, g % period, tol)
        rows["position"].append(mu[:, ref.POS])
        rows["orientation"].append(mu[:, ref.QUAT])
        rows["velocity"].append(mu[:, ref.VEL])
        rows["cov_trace"].append(torch.diagonal(cov, dim1=1, dim2=2).sum(-1))
        for stream, f in nis.items():
            rows[f].append(fired[stream].nis if stream in fired else zero)
        for stream, f in acc.items():
            rows[f].append(fired[stream].accepted if stream in fired else zero.bool())
    return Outputs({k: torch.stack(v) for k, v in rows.items()}, mu=mu, cov=cov)


class Verdict(NamedTuple):
    numbers: dict  # name → reading
    info: dict  # counts that are reported but not compared


class _Gate:
    """The decisions of the reference's gated updates, each following the
    program's within the margin, with the counts of both kinds of
    disagreement."""

    def __init__(self, dev):
        self.mismatch = torch.zeros((), dtype=torch.long, device=dev)
        self.followed = torch.zeros((), dtype=torch.long, device=dev)

    def decider(self, thr: float, accepted_prog):
        def decide(nis):
            near = (nis - thr).abs() <= GATE_MARGIN * thr
            own = nis <= thr
            self.mismatch = self.mismatch + (~near & (own != accepted_prog)).sum()
            self.followed = self.followed + (near & (own != accepted_prog)).sum()
            return torch.where(near, accepted_prog, own)

        return decide


def _mean_sigma(mu_p, mu_r, sd):
    return (ref.boxminus(mu_p, mu_r).abs() / sd).amax(1)


def _cov_rel(cov_p, cov_r, sd):
    return ((cov_p - cov_r).abs() / (sd[:, :, None] * sd[:, None, :])).flatten(1).amax(1)


def judge(inp: Inputs, params: ref.Params, ticks: int, prog: Outputs) -> Verdict:
    """Replay in float64 beside the program's outputs and read every number
    whose per-tick outputs were recorded (module notes); per vehicle worst,
    then the worst and the median over the sample. A NaN anywhere reads
    NaN, which passes no limit."""
    f64 = torch.float64
    dev = inp.gyro.device
    inp = _cast(inp, f64)
    s = inp.mu0.shape[0]
    mu, cov = inp.mu0, inp.cov0.expand(s, ref.N, ref.N)
    have = set(prog.ticks)
    nis = {u["stream"]: u["outputs"]["nis"] for u in inp.updates
           if u.get("outputs", {}).get("nis") in have}
    gated = {u["stream"]: (load_model(u["model"]).GATE, u["outputs"]["accepted"]) for u in _gated(inp.updates)
             if u.get("outputs", {}).get("accepted") in have}
    keys = (["track_sigma", "track_pos_m", "track_ori_rad", "track_vel_mps"] if set(TRACK) <= have else []) \
        + (["trace_rel"] if "cov_trace" in have else []) + list(nis.values())
    worst = {k: torch.zeros(s, dtype=f64, device=dev) for k in keys}
    gate = _Gate(dev)
    period = inp.gyro.shape[0]
    out = lambda name, g: prog.ticks[name][g].to(f64)
    for g in range(ticks):
        j = g % period
        accepted_prog = {st: prog.ticks[f][g].to(dev) for st, (_, f) in gated.items()}
        deciders = {st: gate.decider(thr, accepted_prog[st]) for st, (thr, _) in gated.items()}
        mu, cov, fired = _tick(mu, cov, inp, params, j, 1e-12, deciders)
        sd = torch.sqrt(torch.diagonal(cov, dim1=1, dim2=2))
        now = {}
        if "track_sigma" in worst:
            d_pos = out("position", g) - mu[:, ref.POS]
            d_ori = ref.qlog(ref.qmul(ref.qconj(mu[:, ref.QUAT]), out("orientation", g)))
            d_vel = out("velocity", g) - mu[:, ref.VEL]
            now.update(track_sigma=(torch.cat([d_pos, d_ori, d_vel], 1) / sd[:, 0:9]).abs().amax(1),
                       track_pos_m=d_pos.abs().amax(1), track_ori_rad=d_ori.abs().amax(1),
                       track_vel_mps=d_vel.abs().amax(1))
        if "trace_rel" in worst:
            now["trace_rel"] = (out("cov_trace", g) - sd.square().sum(-1)).abs() / sd.square().sum(-1)
        for stream, f in nis.items():
            r = fired[stream].nis if stream in fired else torch.zeros(s, dtype=f64, device=dev)
            now[f] = (out(f, g) - r).abs() / (1.0 + r)
        for stream, acc in accepted_prog.items():
            if stream not in fired:  # an acceptance reported on a tick without the reading
                gate.mismatch = gate.mismatch + acc.sum()
        for k, v in now.items():
            worst[k] = torch.maximum(worst[k], v)  # carries a NaN or an infinity to the end
    sd = torch.sqrt(torch.diagonal(cov, dim1=1, dim2=2))
    pcov = prog.cov.to(f64)
    worst["final_mean_sigma"] = _mean_sigma(prog.mu.to(f64), mu, sd)
    worst["final_cov_rel"] = _cov_rel(pcov, cov, sd)
    worst["final_var_rel"] = ((torch.diagonal(pcov, dim1=1, dim2=2) - sd.square()).abs() / sd.square()).amax(1)
    nan = lambda v: torch.where(torch.isnan(v).any(), torch.full_like(v[0], float("nan")), v)
    numbers = {k: float(nan(v).amax()) for k, v in worst.items()}
    numbers.update({f"{k}_median": float(nan(v).median()) for k, v in worst.items()})
    if gated:
        numbers["gate_mismatch"] = float(gate.mismatch)
    return Verdict(numbers, {"gate_followed": int(gate.followed), "ticks": ticks, "sample": s})


def decode_lanes(cov_t: torch.Tensor, mu_t: torch.Tensor):
    """The program's kernel-layout state of the sampled vehicles read as
    bank-first: ``cov_t`` (53, 53, S) holds the covariance of vehicle s at
    [column, row ≥ column, s]; ``mu_t`` (54, S) holds its storage mean.
    Returns the (S, 54) means and (S, 53, 53) covariances, mirrored from
    the valid half."""
    lower = torch.tril(cov_t.permute(2, 1, 0))  # (S, row, column), valid where row ≥ column
    cov = lower + lower.transpose(1, 2) - torch.diag_embed(torch.diagonal(lower, dim1=1, dim2=2))
    return mu_t.T.contiguous(), cov


def sample_inputs(start_mu, start_cov, streams: dict, covs: dict, constants: dict, mix: dict, idx) -> Inputs:
    """The inputs of the vehicles ``idx``: the same values the program gets."""
    return Inputs(mu0=start_mu[idx], cov0=start_cov, gyro=streams["gyro"][:, idx],
                  streams={k: v[:, idx] for k, v in streams.items() if k != "gyro"}, covs=covs,
                  constants={k: v[idx] for k, v in constants.items()}, updates=mix["updates"], dt=mix["dt"])


def number_line(numbers: dict, limits: dict) -> dict:
    """The compared numbers beside their limits, for the result line."""
    return {k: {"value": numbers.get(k, float("nan")), "limit": limits[k]} for k in limits}


def passes(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit; a NaN, or a number not read,
    never passes."""
    return all(numbers.get(k, float("nan")) <= limits[k] for k in limits)
