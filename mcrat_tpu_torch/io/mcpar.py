"""mc.par runtime parameter file (port of ``mcrat_tpu.io.mcpar``).

Parses the reference's fixed-layout mc.par format (reference:
Src/mcrat_io.c:1136-1237; format documented at Doc/mcrat_doc.tex:140-211 and
sample_mc.par) so existing MCRaT run directories work unchanged, and writes
the same format back.  Pure Python: either package reads the other's file.
"""
from __future__ import annotations

from ..config import McPar, Spectrum


def _tokens(line: str):
    return line.split("#")[0].split()


def read_mcpar(path: str) -> McPar:
    with open(path) as f:
        lines = f.readlines()

    # collect non-empty, non-block-header data lines in order, mirroring the
    # reference's fixed fgets/fscanf sequence
    data = []
    for ln in lines:
        s = ln.strip()
        if not s or s.startswith("["):
            continue
        toks = _tokens(ln)
        if toks:
            data.append(toks)

    i = 0
    fps = float(data[i][0]); i += 1
    last_frame = int(data[i][0]); i += 1
    r0_dom = (float(data[i][0]), float(data[i][1])); i += 1
    r1_dom = (float(data[i][0]), float(data[i][1])); i += 1
    r2_dom = (float(data[i][0]), float(data[i][1])); i += 1
    theta_min = float(data[i][0]); i += 1
    theta_max = float(data[i][0]); i += 1
    n_bins = int(float(data[i][0])); i += 1
    frm0 = tuple(int(float(x)) for x in data[i][:n_bins]); i += 1
    n_inject = tuple(int(float(x)) for x in data[i][:n_bins]); i += 1
    # frm2 = frm0 + n_inject per bin (reference: mcrat_io.c:1198-1206)
    frm2 = tuple(f0 + dn for f0, dn in zip(frm0, n_inject))
    inj_radius = tuple(float(x) for x in data[i][:n_bins]); i += 1
    spect = Spectrum(data[i][0][0]); i += 1
    min_photons = int(float(data[i][0])); i += 1
    max_photons = int(float(data[i][0])); i += 1
    restart = data[i][0][0]; i += 1

    return McPar(
        fps=fps,
        last_frame=last_frame,
        r0_domain=r0_dom,
        r1_domain=r1_dom,
        r2_domain=r2_dom,
        theta_min_deg=theta_min,
        theta_max_deg=theta_max,
        n_theta_bins=n_bins,
        frm0=frm0,
        frm2=frm2,
        inj_radius=inj_radius,
        spect=spect,
        min_photons=min_photons,
        max_photons=max_photons,
        restart=restart,
    )


def write_mcpar(par: McPar, path: str) -> None:
    n_inject = tuple(f2 - f0 for f0, f2 in zip(par.frm0, par.frm2))
    txt = f"""[Hydro/MHD Simulation Block]

{par.fps:g}               # Number of frames per second of hydro simulation
{par.last_frame}\t\t# Last available hydro simulation frame
{par.r0_domain[0]:g} {par.r0_domain[1]:g}\t\t# Max r0 coordinate limits of hydro simulation
{par.r1_domain[0]:g} {par.r1_domain[1]:g}\t\t# Max r1 coordinate limit of hydro simulation
{par.r2_domain[0]:g} {par.r2_domain[1]:g}\t\t# Max r2 coordinate limit of hydro simulation (if simulation is 3D)

[MCRaT Injection Angles Block]

{par.theta_min_deg:g}               \t# The minimum off-axis angle to inject photons (in degrees)
{par.theta_max_deg:g}               \t# The maximum off-axis angle to inject photons (in degrees)
{par.n_theta_bins}\t\t\t# Number of angle bins to consider
{' '.join(str(x) for x in par.frm0)}      \t# Frame at which photon injection starts for each angle bin
{' '.join(str(x) for x in n_inject)}            \t# Number of frames for which photons are injected for each angle bin
{' '.join(f'{x:g}' for x in par.inj_radius)}\t# The radius at which the photons are injected for each angle bin

[MCRaT Photon Block]

{par.spect.value}\t\t# Type of spectrum we inject with, w=wien b=blackbody
{par.min_photons}\t\t# Min number of photons
{par.max_photons}\t\t# Max number of photons

[Initialization/Continuation Block]

{par.restart}\t\t# Initialize or continue simulation (i=initialize (delete all files) c=continue)
"""
    with open(path, "w") as f:
        f.write(txt)
