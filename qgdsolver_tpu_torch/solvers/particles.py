"""Lagrangian parcel clouds and the particlesQGDFoam, particlesQHDFoam and
reactingLagrangianQGDFoam solvers (PyTorch port of
`qgdsolver_tpu.solvers.particles`).

The reference's basicThermoCloud (parcels.evolve(); two-way momentum and
energy sources rhoUSu = parcels.SU(U), rhoESu = parcels.Sh(e); one-way for
particlesQHDFoam) is here a fixed-size structure of arrays:
  * the owner cell of a parcel by a per-axis `searchsorted` of its position
    among the face coordinates, in float64;
  * gas properties at the owner cell (OpenFOAM's cell-value interpolation);
  * Schiller-Naumann drag and Ranz-Marshall heat transfer with exact
    exponential integrators;
  * two-way sources by `ops.deposit.deposit` of each parcel's exchange
    into its owner cell before the move: each cell's parcels added in
    parcel order from zero, on the card by a sort and csrc/deposit.cu's
    kernel, so the card's sources equal the CPU's bit for bit;
  * escape (deactivate), periodic or rebound walls against the global
    domain bounds.

Decomposed (`parallel.sharding.build_spmd_step`), each rank holds the slots
of the parcels resident in its block; after the move, parcels that left the
block hop to the neighbour block along each decomposed axis in turn
(`spmd.hop_exchange`), to the block their position lies in (a parcel that
wrapped a periodic edge goes to the cyclic neighbour across it), and fill
free slots.  Parcels that find no free slot, or would have to jump more
than one block, are counted on the device in `CloudState.dropped`; the CLI
reads the count with the solution time once a chunk (`raise_dropped`).
"""
from __future__ import annotations

import dataclasses
import math
import typing as tp

import numpy as np
import torch

from ..core.mesh import Mesh
from ..ops.deposit import deposit
from ..parallel import spmd


class CloudState(tp.NamedTuple):
    x: torch.Tensor  # (d, N) positions
    u: torch.Tensor  # (d, N) velocities
    Tp: torch.Tensor  # (N,) temperatures
    dp: torch.Tensor  # (N,) diameters
    active: torch.Tensor  # (N,) 0/1 mask
    # parcels a decomposed run lost (an int64 0-dim tensor on the device),
    # None in a serial run
    dropped: tp.Any = None


def owner_cells(x, mesh) -> tuple:
    """Per-axis owner-cell indices of positions x (d, N): a float64
    `searchsorted` among the mesh's face coordinates, clipped to the
    mesh."""
    return tuple(torch.clamp(
        torch.searchsorted(mesh.faces_f64[a], x[a].to(torch.float64),
                           right=True) - 1, 0, mesh.shape[a] - 1)
        for a in range(mesh.ndim))


def _flat(idx, mesh):
    flat = idx[0]
    for a in range(1, mesh.ndim):
        flat = flat * mesh.shape[a] + idx[a]
    return flat


def _positive(dt):
    """dt floored at 1e-30 (a tensor or a number, kept so)."""
    return torch.clamp(dt, min=1e-30) if torch.is_tensor(dt) \
        else max(dt, 1e-30)


@dataclasses.dataclass(frozen=True)
class ThermoCloud:
    """basicThermoCloud: inert spherical parcels with drag and heat
    exchange."""

    rho_p: float = 1000.0  # parcel material density
    Cp_p: float = 4187.0  # parcel specific heat
    mu_g: float = 1.8e-5  # gas viscosity of the drag and heat correlations
    kappa_g: float = 0.026  # gas conductivity (Ranz-Marshall)
    Pr_g: float = 0.7
    two_way: bool = True  # particlesQGDFoam two-way, QHD one-way
    wall: str = "escape"  # "escape" | "periodic" | "rebound"

    def make(self, x, u, Tp, dp, device=None, dtype=None) -> CloudState:
        """A cloud of every given parcel, active (numpy or tensors)."""
        x, u, Tp, dp = (torch.as_tensor(v, device=device, dtype=dtype)
                        for v in (x, u, Tp, dp))
        return CloudState(x=x, u=u, Tp=Tp, dp=dp,
                          active=torch.ones(x.shape[1], dtype=x.dtype,
                                            device=x.device))

    def mass(self, c: CloudState):
        return self.rho_p * math.pi / 6.0 * c.dp ** 3

    def locate(self, c: CloudState, mesh: Mesh):
        """Owner-cell indices per parcel."""
        return owner_cells(c.x, mesh)

    def evolve(self, c: CloudState, mesh: Mesh, dt, *, rho_g, U_g, T_g):
        """One parcel step (parcels.evolve).  Returns (cloud', rhoUSu,
        rhoESu): the exchange source fields [kg/(m^2 s^2)] and [W/m^3],
        the gas losing what the parcels gain."""
        nd = mesh.ndim
        flat = _flat(self.locate(c, mesh), mesh)
        rho_at = rho_g.reshape(-1)[flat]
        T_at = T_g.reshape(-1)[flat]
        U_at = torch.stack([U_g[a].reshape(-1)[flat] for a in range(nd)])

        m = self.mass(c)
        act = c.active

        # Schiller-Naumann drag: tau_p = rho_p dp^2/(18 mu)/(1+0.15 Re^0.687)
        du = U_at - c.u
        rel = torch.sqrt(torch.sum(du * du, dim=0))
        Re = torch.clamp(rho_at * rel * c.dp / self.mu_g, min=1e-12)
        f = 1.0 + 0.15 * Re ** 0.687
        tau_p = self.rho_p * c.dp ** 2 / (18.0 * self.mu_g) / f
        # the exact exponential integrator of the linear relaxation
        fac = 1.0 - torch.exp(-dt / torch.clamp(tau_p, min=1e-12))
        dup = du * fac * act
        u_new = c.u + dup
        x_new = c.x + dt * u_new

        # Ranz-Marshall heat transfer: Nu = 2 + 0.6 Re^1/2 Pr^1/3
        Nu = 2.0 + 0.6 * torch.sqrt(Re) * self.Pr_g ** (1.0 / 3.0)
        h = Nu * self.kappa_g / torch.clamp(c.dp, min=1e-12)
        A_p = math.pi * c.dp ** 2
        tau_T = m * self.Cp_p / torch.clamp(h * A_p, min=1e-30)
        facT = 1.0 - torch.exp(-dt / tau_T)
        dTp = (T_at - c.Tp) * facT * act
        Tp_new = c.Tp + dTp

        # walls against the global domain bounds: decomposed, the block
        # edges are partition faces, which parcels cross by migrating
        ctx = spmd.current()
        gmesh = ctx.global_mesh if ctx is not None else mesh
        active = act
        xs = []
        for a in range(nd):
            lo = float(gmesh.x_faces[a][0])
            hi = float(gmesh.x_faces[a][-1])
            xa = x_new[a]
            if self.wall == "periodic":
                xa = lo + torch.remainder(xa - lo, hi - lo)
            elif self.wall == "rebound":
                xa = torch.where(xa < lo, 2 * lo - xa, xa)
                xa = torch.where(xa > hi, 2 * hi - xa, xa)
            else:  # escape: deactivate
                out = (xa < lo) | (xa > hi)
                active = active * (1.0 - out.to(active.dtype))
                xa = torch.clamp(xa, lo, hi)
            xs.append(xa)
        cloud = CloudState(x=torch.stack(xs), u=u_new, Tp=Tp_new, dp=c.dp,
                           active=active, dropped=c.dropped)
        # the sources below use the pre-move owner cells, which are local
        cloud = migrate(cloud, mesh)

        if not self.two_way:
            z = torch.zeros(mesh.shape, dtype=rho_g.dtype,
                            device=rho_g.device)
            return cloud, torch.zeros((nd,) + mesh.shape, dtype=rho_g.dtype,
                                      device=rho_g.device), z

        # two-way sources, per cell and volume
        vol = torch.broadcast_to(mesh.cell_volume, mesh.shape).reshape(
            -1)[flat]
        w = act / (vol * _positive(dt))
        # energy: convective heat to the parcels and the drag's work
        q_p = m * self.Cp_p * dTp
        work = m * torch.sum(dup * U_at, dim=0)
        # the momentum rows and the energy row in one deposition (one sort)
        src = deposit(torch.stack([-m * dup[a] * w for a in range(nd)]
                                  + [-(q_p + work) * w]), flat,
                      int(np.prod(mesh.shape)))
        src = src.reshape((nd + 1,) + mesh.shape)
        return cloud, src[:nd], src[nd]


def hop_masks(xa, act, a: int, ctx):
    """(up, down, lost) 0/1 masks of the parcels that leave this block
    along axis a: to the next block, to the previous one (cyclically), or
    farther than one block.  The destination is the block a parcel's
    position lies in, so one that wrapped a periodic edge goes to the
    cyclic neighbour across that edge."""
    n = ctx.axes[a].size
    c = ctx.coords[a]
    cell = torch.clamp(torch.searchsorted(
        ctx.global_mesh.faces_f64[a], xa.to(torch.float64), right=True) - 1,
        0, ctx.global_shape[a] - 1)
    dest = torch.div(cell, ctx.axes[a].n_local, rounding_mode="floor")
    up = dest == (c + 1) % n
    down = (dest == (c - 1) % n) & ~up
    lost = (dest != c) & ~up & ~down
    return (act * up.to(act.dtype), act * down.to(act.dtype),
            act * lost.to(act.dtype))


def migrate(c: CloudState, mesh) -> CloudState:
    """Move the parcels that left this rank's block to the neighbour
    blocks (the reference's processor-boundary particle transfer): per
    decomposed axis, one cyclic hop of the slot arrays each way
    (`spmd.hop_exchange`), so a diagonal mover reaches the corner block in
    two hops.  Arrivals fill free slots through a stable active-first sort;
    parcels beyond the slot count, and those `hop_masks` finds more than
    one block away, are dropped and counted in `dropped`.  A no-op outside
    an spmd context."""
    ctx = spmd.current()
    if ctx is None:
        return c
    nd = mesh.ndim
    cap = c.active.shape[0]
    # one tensor of the slot rows: x (nd), u (nd), Tp, dp, active
    rows = torch.cat([c.x, c.u, c.Tp[None], c.dp[None], c.active[None]])
    dropped = (torch.zeros((), dtype=torch.int64, device=rows.device)
               if c.dropped is None else c.dropped)
    for a in range(nd):
        if not ctx.sharded(a):
            continue
        act = rows[-1]
        up, down, lost = hop_masks(rows[a], act, a, ctx)
        stay = act - up - down - lost
        from_prev, from_next = spmd.hop_exchange(
            a, torch.cat([rows[:-1], up[None]]),
            torch.cat([rows[:-1], down[None]]))
        pool = torch.cat([torch.cat([rows[:-1], stay[None]]), from_prev,
                          from_next], dim=1)
        order = torch.argsort((pool[-1] < 0.5).to(torch.uint8),
                              stable=True)[:cap]
        kept = pool[:, order]
        dropped = dropped + (torch.sum(pool[-1]) - torch.sum(kept[-1])
                             + torch.sum(lost)).round().to(torch.int64)
        rows = kept
    return CloudState(x=rows[:nd], u=rows[nd:2 * nd], Tp=rows[2 * nd],
                      dp=rows[2 * nd + 1], active=rows[2 * nd + 2],
                      dropped=dropped)


def raise_dropped(state) -> None:
    """Raise if a decomposed cloud lost parcels (`CloudState.dropped`,
    summed over the ranks of a launched world: a collective, every rank
    calls it).  The CLI
    calls it where it reads the solution time, once a chunk."""
    cloud = getattr(state, "cloud", None)
    if cloud is None or cloud.dropped is None:
        return
    n = int(sum(spmd.all_gather(cloud.dropped)))
    if n:
        raise RuntimeError(
            f"the decomposed cloud dropped {n} parcels: a rank's slots "
            "were full (raise the capacity) or a parcel moved more than "
            "one block in a step")


def resident_ranks(cloud: CloudState, mesh, grid) -> np.ndarray:
    """The rank whose block holds each parcel (host numpy; -1 for an
    inactive one).  Raises ValueError for an active parcel outside the
    mesh, which no block holds."""
    x = cloud.x.detach().cpu().double().numpy()
    active = cloud.active.detach().cpu().numpy() > 0.5
    coords = []
    for a, n_blocks in enumerate((grid.px, grid.py)[:mesh.ndim]):
        xf = np.asarray(mesh.x_faces[a])
        out = active & ((x[a] < xf[0]) | (x[a] > xf[-1]))
        if out.any():
            k = int(np.argmax(out))
            raise ValueError(
                f"parcel {k} at {x[:, k].tolist()} lies outside the mesh "
                f"along axis {a} ([{xf[0]}, {xf[-1]}]): no block holds it")
        cell = np.clip(np.searchsorted(xf, x[a], side="right") - 1, 0,
                       mesh.shape[a] - 1)
        coords.append(cell // (mesh.shape[a] // n_blocks))
    # ProcessGrid.rank(ix, iy) = iy*px + ix
    ranks = coords[0] + (coords[1] * grid.px if len(coords) > 1 else 0)
    return np.where(active, ranks, -1)


def distribute_cloud(cloud: CloudState, mesh, grid,
                     capacity: int = None) -> CloudState:
    """decomposePar of a cloud: the slots reordered into one block of
    `capacity` slots a rank, rank order, block r holding the parcels
    resident in rank r's spatial block (`resident_ranks`), active first.
    capacity defaults to the cloud's slot count, which no rank can
    overflow; a rank with more residents raises ValueError."""
    cap = int(capacity if capacity is not None else cloud.active.shape[0])
    ranks = resident_ranks(cloud, mesh, grid)
    sel = []
    for r in range(grid.size):
        idx = np.nonzero(ranks == r)[0]
        if len(idx) > cap:
            raise ValueError(f"rank {r} holds {len(idx)} parcels > "
                             f"capacity {cap}")
        sel.append(idx)
    out = {}
    for f in ("x", "u", "Tp", "dp", "active"):
        v = getattr(cloud, f)
        blk = torch.zeros(v.shape[:-1] + (grid.size * cap,), dtype=v.dtype,
                          device=v.device)
        for r, idx in enumerate(sel):
            blk[..., r * cap: r * cap + len(idx)] = v[
                ..., torch.as_tensor(idx, device=v.device)]
        out[f] = blk
    return CloudState(**out)


class PState(tp.NamedTuple):
    fluid: tp.Any
    cloud: CloudState


@dataclasses.dataclass(frozen=True)
class ParticlesQGDFoam:
    """particlesQGDFoam: QGDFoam with a two-way thermo cloud, its sources
    added through QGDFoam's `make_step(external_sources=True)`."""

    fluid: tp.Any  # QGDFoam
    cloud: ThermoCloud = ThermoCloud()

    @property
    def mesh(self):
        return self.fluid.mesh

    def init(self, p0, T0, U0, x_p, u_p, T_p, d_p, **kw) -> PState:
        mesh = self.mesh
        return PState(fluid=self.fluid.init(p0, T0, U0, **kw),
                      cloud=self.cloud.make(x_p, u_p, T_p, d_p,
                                            device=mesh.device,
                                            dtype=mesh.dtype))

    def make_step(self):
        fstep = self.fluid.make_step(external_sources=True)
        mesh = self.fluid.mesh

        def step(s: PState) -> PState:
            U, e, T, p = self.fluid.primitives(s.fluid)
            stash = {}

            def srcs(dt_new):
                cloud, rhoUSu, rhoESu = self.cloud.evolve(
                    s.cloud, mesh, dt_new, rho_g=s.fluid.rho, U_g=U, T_g=T)
                stash["cloud"] = cloud
                return 0.0, rhoUSu, rhoESu

            fluid = fstep(s.fluid, srcs)
            return PState(fluid=fluid, cloud=stash["cloud"])

        return step


@dataclasses.dataclass(frozen=True)
class ParticlesQHDFoam:
    """particlesQHDFoam: QHDFoam with a one-way cloud (evolved on the
    pre-step fields; the QHD equations get no source)."""

    fluid: tp.Any  # QHDFoam
    cloud: ThermoCloud = ThermoCloud(two_way=False)

    @property
    def mesh(self):
        return self.fluid.mesh

    def init(self, U0, T0, x_p, u_p, T_p, d_p, **kw) -> PState:
        mesh = self.mesh
        return PState(fluid=self.fluid.init(U0, T0, **kw),
                      cloud=self.cloud.make(x_p, u_p, T_p, d_p,
                                            device=mesh.device,
                                            dtype=mesh.dtype))

    def make_step(self):
        fstep = self.fluid.make_step()
        mesh = self.fluid.mesh
        thermo = self.fluid.thermo

        def step(s: PState) -> PState:
            T = s.fluid.T
            rho = thermo.rho(s.fluid.p, T)
            cloud, _, _ = self.cloud.evolve(s.cloud, mesh, s.fluid.dt,
                                            rho_g=rho, U_g=s.fluid.U, T_g=T)
            return PState(fluid=fstep(s.fluid), cloud=cloud)

        return step


@dataclasses.dataclass(frozen=True)
class ReactingCloud(ThermoCloud):
    """basicReactingCloud: ThermoCloud with d^2-law evaporation; the
    evaporated mass enters the gas as specie `evap_specie` (parcels.SYi in
    QGDYEqn), with a latent-heat sink per kg."""

    evap_specie: int = 0
    K_evap: float = 0.0  # d^2-law constant [m^2/s]: d(dp^2)/dt = -K
    latent_heat: float = 0.0  # J/kg

    def evolve_reacting(self, c: CloudState, mesh: Mesh, dt, *, rho_g, U_g,
                        T_g, n_species: int):
        """(cloud', rhoSu, rhoUSu, rhoESu, YSu list)."""
        cloud, rhoUSu, rhoESu = self.evolve(c, mesh, dt, rho_g=rho_g,
                                            U_g=U_g, T_g=T_g)
        # d^2-law evaporation of the moved cloud, deposited in its new
        # (local) owner cells
        dp2 = torch.clamp(cloud.dp ** 2 - self.K_evap * dt * cloud.active,
                          min=0.0)
        dp_new = torch.sqrt(dp2)
        dm = self.rho_p * math.pi / 6.0 * (cloud.dp ** 3 - dp_new ** 3)
        cloud = cloud._replace(dp=dp_new)
        flat = _flat(self.locate(cloud, mesh), mesh)
        vol = torch.broadcast_to(mesh.cell_volume, mesh.shape).reshape(
            -1)[flat]
        w = cloud.active / (vol * _positive(dt))
        src = deposit((dm * w)[None], flat, int(np.prod(mesh.shape)))[0]
        src = src.reshape(mesh.shape)
        YSu = [torch.zeros_like(src) for _ in range(n_species)]
        YSu[self.evap_specie] = src
        return cloud, src, rhoUSu, rhoESu - self.latent_heat * src, YSu


@dataclasses.dataclass(frozen=True)
class ReactingLagrangianQGDFoam:
    """reactingLagrangianQGDFoam: the reacting QGD solver with a two-way
    reacting cloud (parcels.SU into rhoUSu, parcels.Sh + Qdot into the
    energy, parcels.SYi into the species), the cloud evolved from the
    pre-step state through the solver's `sources` hook."""

    fluid: tp.Any  # ReactingQGDFoam
    cloud: ReactingCloud = ReactingCloud()

    @property
    def mesh(self):
        return self.fluid.mesh

    def init(self, p0, T0, U0, Y0, x_p, u_p, T_p, d_p, **kw) -> PState:
        mesh = self.mesh
        return PState(fluid=self.fluid.init(p0, T0, U0, Y0, **kw),
                      cloud=self.cloud.make(x_p, u_p, T_p, d_p,
                                            device=mesh.device,
                                            dtype=mesh.dtype))

    def make_step(self):
        mesh = self.fluid.mesh
        ns = self.fluid.mixture.n_species
        box = {}

        def hook(st, prims, dt_new):
            U, e, T, p = prims
            cloud, rhoSu, rhoUSu, rhoESu, YSu = self.cloud.evolve_reacting(
                box["cloud"], mesh, dt_new, rho_g=st.rho, U_g=U, T_g=T,
                n_species=ns)
            box["cloud"] = cloud
            return rhoSu, rhoUSu, rhoESu, YSu

        fstep = self.fluid.make_step(sources=hook)

        def step(s: PState) -> PState:
            box["cloud"] = s.cloud
            fluid = fstep(s.fluid)
            return PState(fluid=fluid, cloud=box.pop("cloud"))

        return step
