"""Independent re-transcription oracle of the reference formula chain.

This module is deliberately self-contained: it imports NOTHING from
`adiabatic_raytracer` and was transcribed afresh, line by line, from the
Julia source of the reference (file:line citations at each function).  Its
purpose is to break the self-referentiality of the parity tests — the scipy
oracle integrates the package's own RHS and the conversion-prob pins are
literals generated by the same code, so a transcription error in the formula
chain (e.g. a sign in a Christoffel term) would pass every other test.  Here
the same quantities are recomputed with plain mpmath arithmetic and
high-precision adaptive finite differences (mpmath.diff) in place of AD.

Everything is scalar, one point at a time, in mpmath arbitrary precision
(mp.dps set by the test).  Coordinates: x_pl = (r, theta, phi) spherical
[km]; momenta `ksphere` covariant spherical ("celerity") components.

Transcribed from /root/reference/src/RayTracer.jl and MainRunner.jl; the
specific line ranges are cited on each function.
"""

import mpmath as mp

# Constants.jl:1-6
C_KM = mp.mpf("2.99792e5")
HBAR = mp.mpf("6.582119e-16")
GNEW = mp.mpf("132712000000.0")
GAUSS = mp.mpf("1.95e-2")  # the literal 1.95e-2 eV^2/Gauss used throughout


def _m(x):
    return [mp.mpf(v) for v in x]


def g_schwartz(x_pl, mass_ns, r_ns=10.0):
    """RayTracer.jl:455-501 (scalar branch), signature (-,+,+,+), upper g."""
    r, theta, _ = _m(x_pl)
    r_ns = mp.mpf(r_ns)
    rs = 2 * GNEW * mp.mpf(mass_ns) / C_KM**2
    if r <= r_ns:
        rs = rs * (r / r_ns) ** 3
    sin_theta = mp.sin(theta)
    g_tt = -1 / (1 - rs / r)
    g_rr = 1 - rs / r
    g_thth = 1 / r**2
    g_pp = 1 / (r**2 * sin_theta**2)
    if r <= r_ns:
        g_tt = -4 / (3 * mp.sqrt(1 - rs / r_ns)
                     - mp.sqrt(1 - r**2 * rs / r_ns**3)) ** 2
        g_rr = 1 - r**2 * rs / r_ns**3
    return g_tt, g_rr, g_thth, g_pp


def cristoffel(x_pl, mass_ns):
    """RayTracer.jl:503-527.  Note the reference computes GM from the full
    NS mass regardless of its own `flat` switch (MassNS assigned, GM uses
    Mass_NS)."""
    r, theta, _ = _m(x_pl)
    gm = GNEW * mp.mpf(mass_ns) / C_KM**2
    g_rrr = -gm / (r * (r - 2 * gm))
    g_rtt = -(r - 2 * gm)
    g_rpp = -(r - 2 * gm) * mp.sin(theta) ** 2
    g_trt = 1 / r
    g_tpp = -mp.sin(theta) * mp.cos(theta)
    g_prp = 1 / r
    g_ptp = mp.cos(theta) / mp.sin(theta)
    g_ttr = 1 / r
    g_ppr = 1 / r
    g_ppt = mp.cos(theta) / mp.sin(theta)
    return g_rrr, g_rtt, g_rpp, g_trt, g_tpp, g_prp, g_ptp, g_ttr, g_ppr, g_ppt


def _dipole(x_pl, t, theta_m, omega, b0, r_ns):
    """Shared dipole block of GJ_Model_ωp_vecSPH / GJ_Model_Sphereical
    (RayTracer.jl:1141-1148, 1288-1294)."""
    r, theta, phi = _m(x_pl)
    t, theta_m, omega, b0, r_ns = (mp.mpf(t), mp.mpf(theta_m), mp.mpf(omega),
                                   mp.mpf(b0), mp.mpf(r_ns))
    psi = phi - omega * t
    bnorm = b0 * (r_ns / r) ** 3 / 2
    br = 2 * bnorm * (mp.cos(theta_m) * mp.cos(theta)
                      + mp.sin(theta_m) * mp.sin(theta) * mp.cos(psi))
    btheta = bnorm * (mp.cos(theta_m) * mp.sin(theta)
                      - mp.sin(theta_m) * mp.cos(theta) * mp.cos(psi))
    bphi = bnorm * mp.sin(theta_m) * mp.sin(psi)
    return br, btheta, bphi


def gj_wp(x_pl, t, theta_m, omega, b0, r_ns, zero_in=True, bndry_lyr=-1,
          mass_a=1e-5):
    """GJ_Model_ωp_vecSPH (RayTracer.jl:1120-1170), scalar."""
    r = mp.mpf(x_pl[0])
    r_ns = mp.mpf(r_ns)
    omega = mp.mpf(omega)
    br, btheta, _ = _dipole(x_pl, t, theta_m, omega, b0, r_ns)
    theta = mp.mpf(x_pl[1])
    bz = br * mp.cos(theta) - btheta * mp.sin(theta)
    nelec = abs(2 * omega * bz / mp.sqrt(4 * mp.pi / 137) * GAUSS * HBAR)
    wp = mp.sqrt(4 * mp.pi * nelec / 137 / mp.mpf("5.0e5"))
    if r >= r_ns and mp.mpf(bndry_lyr) > 0:
        nelec_pole = abs(2 * omega * mp.mpf(b0) / mp.sqrt(4 * mp.pi / 137)
                         * GAUSS * HBAR)
        pole_val = mp.sqrt(4 * mp.pi * nelec_pole / 137 / mp.mpf("5.0e5"))
        rmax = r_ns * (pole_val / mp.mpf(mass_a)) ** (mp.mpf(2) / 3)
        wp += pole_val * (r_ns / r) ** mp.mpf("1.5") * mp.exp(
            -(r - rmax * mp.mpf(bndry_lyr)) / (mp.mpf("0.1") * rmax))
    if zero_in and r <= r_ns:
        wp = mp.mpf(0)
    return wp


def gj_spherical(x_pl, t, theta_m, omega, b0, r_ns, mass_ns, flat=False,
                 return_comp=-1):
    """GJ_Model_Sphereical with sphericalX=true (RayTracer.jl:1268-1309).
    flat=true zeroes the metric mass (only) inside this function."""
    if flat:
        mass_ns = 0.0
    br, btheta, bphi = _dipole(x_pl, t, theta_m, omega, b0, r_ns)
    if return_comp == 0:
        return mp.sqrt(br**2 + btheta**2 + bphi**2) * GAUSS
    _, g_rr, g_thth, g_pp = g_schwartz(x_pl, mass_ns)
    if return_comp == -1:
        return [br / mp.sqrt(g_rr), btheta / mp.sqrt(g_thth),
                bphi / mp.sqrt(g_pp)]
    if return_comp == 1:
        return br / mp.sqrt(g_rr) * g_rr * GAUSS
    if return_comp == 2:
        return btheta / mp.sqrt(g_thth) * g_thth * GAUSS
    if return_comp == 3:
        return bphi / mp.sqrt(g_pp) * g_pp * GAUSS
    raise ValueError(return_comp)


def spatial_dot(v1, v2, x_pl, mass_ns):
    """RayTracer.jl:973-981."""
    _, g_rr, g_thth, g_pp = g_schwartz(x_pl, mass_ns)
    return g_rr * v1[0] * v2[0] + g_thth * v1[1] * v2[1] + g_pp * v1[2] * v2[2]


def k_par(x_pl, ks, t, theta_m, omega, b0, r_ns, mass_ns, flat=False):
    """K_par (RayTracer.jl:1044-1058)."""
    bs = gj_spherical(x_pl, t, theta_m, omega, b0, r_ns, mass_ns, flat=flat)
    _, g_rr, g_thth, g_pp = g_schwartz(x_pl, mass_ns)
    bmag = mp.sqrt(g_rr * bs[0] ** 2 + g_thth * bs[1] ** 2 + g_pp * bs[2] ** 2)
    return (g_rr * ks[0] * bs[0] + g_thth * ks[1] * bs[1]
            + g_pp * ks[2] * bs[2]) / bmag


def omega_function(x_pl, ks, t, theta_m, omega, b0, r_ns, mass_ns, mass_a,
                   iso=False, kmag=None, zero_in=False, bndry_lyr=-1):
    """omega_function (RayTracer.jl:558-589), anisotropic Melrose branch.
    Note the verbatim `/ sqrt(2)` (not /2) under the outer sqrt
    (RayTracer.jl:584)."""
    x_pl = list(_m(x_pl))
    if x_pl[0] < mp.mpf(r_ns):
        x_pl[0] = mp.mpf(r_ns)
    wp = gj_wp(x_pl, t, theta_m, omega, b0, r_ns, zero_in=zero_in,
               bndry_lyr=bndry_lyr, mass_a=mass_a)
    _, g_rr, g_thth, g_pp = g_schwartz(x_pl, mass_ns)
    if kmag is None:
        ksqr = g_rr * ks[0] ** 2 + g_thth * ks[1] ** 2 + g_pp * ks[2] ** 2
    else:
        ksqr = mp.mpf(kmag) ** 2
    if iso:
        return mp.sqrt(ksqr + wp**2)
    kp = k_par(x_pl, ks, t, theta_m, omega, b0, r_ns, mass_ns)
    ham = (ksqr + wp**2 + mp.sqrt(ksqr**2 + 2 * ksqr * wp**2
                                  - 4 * kp**2 * wp**2 + wp**4)) / mp.sqrt(2)
    return mp.sqrt(ham)


def _cart_to_celerity(x0, k0, mass_ns):
    """The inline Cartesian->celerity transform shared by k_norm_Cart and
    k_sphere (RayTracer.jl:646-662, 996-1008)."""
    x0 = _m(x0)
    k0 = _m(k0)
    rr = mp.sqrt(x0[0] ** 2 + x0[1] ** 2 + x0[2] ** 2)
    theta = mp.acos(x0[2] / rr)
    phi = mp.atan2(x0[1], x0[0])
    x_pl = [rr, theta, phi]
    dr_dt = (x0[0] * k0[0] + x0[1] * k0[1] + x0[2] * k0[2]) / rr
    v_th = (x0[2] * dr_dt - rr * k0[2]) / (rr * mp.sin(theta))
    v_ph = (-x0[1] * k0[0] + x0[0] * k0[1]) / (rr * mp.sin(theta))
    r_s0 = 2 * mp.mpf(mass_ns) * GNEW / C_KM**2
    aa = 1 - r_s0 / rr
    w = [dr_dt / mp.sqrt(aa) / aa,
         v_th / rr * rr**2 / aa,
         v_ph / (rr * mp.sin(theta)) * (rr * mp.sin(theta)) ** 2 / aa]
    return x_pl, w


def k_sphere(x0, k0, mass_ns, flat=False):
    """k_sphere (RayTracer.jl:983-1008): Cartesian velocity -> covariant
    celerity, with the flat switch zeroing the mass."""
    if flat:
        mass_ns = 0.0
    _, w = _cart_to_celerity(x0, k0, mass_ns)
    return w


def k_norm_cart(x0, khat, t, erg, theta_m, omega, b0, r_ns, mass_ns, mass_a,
                is_photon=True, ax_fix=False, isotropic=False, flat=False,
                bndry_lyr=-1):
    """k_norm_Cart (RayTracer.jl:643-685).  The celerity transform always
    uses the full NS mass; `flat` reaches only the K_par B-lowering."""
    x_pl, w = _cart_to_celerity(x0, khat, mass_ns)
    g_tt, g_rr, g_thth, g_pp = g_schwartz(x_pl, mass_ns)
    wsq = g_rr * w[0] ** 2 + g_thth * w[1] ** 2 + g_pp * w[2] ** 2
    erg = mp.mpf(erg)
    if (not is_photon) or ax_fix:
        nrm_sq = (-erg**2 * g_tt - mp.mpf(mass_a) ** 2) / wsq
    else:
        wp = gj_wp(x_pl, t, theta_m, omega, b0, r_ns, zero_in=True,
                   bndry_lyr=bndry_lyr, mass_a=mass_a)
        kp = mp.mpf(0) if isotropic else k_par(
            x_pl, w, t, theta_m, omega, b0, r_ns, mass_ns, flat=flat)
        nrm_sq = (-erg**2 * g_tt - wp**2) / (
            wsq - wp**2 / (-erg**2 * g_tt) * kp**2)
    return [mp.sqrt(nrm_sq) * mp.mpf(k) for k in khat]


def k_gamma(x_pl, ks, t, erg_inf_ini, theta_m, omega, b0, r_ns, mass_ns,
            mass_a, isotropic=False, flat=False, bndry_lyr=-1):
    """k_gamma (RayTracer.jl:1311-1325).  Quirk preserved verbatim:
    erg_loc = erg_inf / g_rr (not / sqrt(g_rr))."""
    _, g_rr, g_thth, g_pp = g_schwartz(x_pl, mass_ns)
    bs = gj_spherical(x_pl, t, theta_m, omega, b0, r_ns, mass_ns, flat=flat)
    wp = gj_wp(x_pl, t, theta_m, omega, b0, r_ns, zero_in=True,
               bndry_lyr=bndry_lyr, mass_a=mass_a)
    kmag = mp.sqrt(g_rr * ks[0] ** 2 + g_thth * ks[1] ** 2 + g_pp * ks[2] ** 2)
    bmag = mp.sqrt(g_rr * bs[0] ** 2 + g_thth * bs[1] ** 2 + g_pp * bs[2] ** 2)
    ct = (g_rr * bs[0] * ks[0] + g_thth * bs[1] * ks[1]
          + g_pp * bs[2] * ks[2]) / (kmag * bmag)
    if isotropic:
        ct = mp.mpf(0)
    erg_loc = mp.mpf(erg_inf_ini) / g_rr
    return erg_loc * mp.sqrt(erg_loc**2 - wp**2) / mp.sqrt(
        erg_loc**2 - wp**2 * ct**2)


def _grad3(f, x_pl):
    """3-vector gradient via mpmath adaptive central differences."""
    x = _m(x_pl)

    def comp(i):
        def fi(v):
            y = list(x)
            y[i] = v
            return f(y)
        return mp.diff(fi, x[i])

    return [comp(0), comp(1), comp(2)]


def dwp_ds(x_cart, ks, t, w_erg, theta_m, omega, b0, r_ns, mass_ns, mass_a,
           flat=False, isotropic=False, bndry_lyr=-1):
    """dwp_ds (RayTracer.jl:1327-1403): the gradient bundle along the ray.
    Returns (|w'|, |k'|, |newGuess|, cos_w, vgNorm, dk_vg, dE_vg, k_vg)."""
    x_cart = _m(x_cart)
    ks = _m(ks)
    w_erg = mp.mpf(w_erg)
    rr = mp.sqrt(sum(v**2 for v in x_cart))
    x_pl = [rr, mp.acos(x_cart[2] / rr), mp.atan2(x_cart[1], x_cart[0])]
    wp = gj_wp(x_pl, t, theta_m, omega, b0, r_ns, zero_in=True,
               bndry_lyr=bndry_lyr, mass_a=mass_a)
    erg_inf_ini = mp.sqrt(1 - 2 * GNEW * mp.mpf(mass_ns) / rr / C_KM**2) * w_erg
    _, g_rr, g_thth, g_pp = g_schwartz(x_pl, mass_ns)
    # NB: the reference calls GJ_Model_Sphereical with the CARTESIAN xIn and
    # sphericalX defaulting to false — it re-derives the same spherical point.
    bs = gj_spherical(x_pl, t, theta_m, omega, b0, r_ns, mass_ns, flat=flat)
    kmag = mp.sqrt(spatial_dot(ks, ks, x_pl, mass_ns))
    khat = [k / kmag for k in ks]
    kb_norm = spatial_dot(bs, khat, x_pl, mass_ns)
    v_ortho = [-(b - kb_norm * kh) for b, kh in zip(bs, khat)]
    vnorm = mp.sqrt(spatial_dot(v_ortho, v_ortho, x_pl, mass_ns))
    v_ortho = [v / vnorm for v in v_ortho]
    bmag = mp.sqrt(spatial_dot(bs, bs, x_pl, mass_ns))
    ct = spatial_dot(bs, ks, x_pl, mass_ns) / (kmag * bmag)
    st = mp.sin(mp.acos(ct))
    if isotropic:
        ct = mp.mpf(0)
        st = mp.mpf(1)
    xi = st**2 / (1 - ct**2 * wp**2 / w_erg**2)
    mix = wp**2 / w_erg**2 * xi / (st / ct)

    grad_wp = _grad3(
        lambda x: gj_wp(x, t, theta_m, omega, b0, r_ns, zero_in=True,
                        bndry_lyr=bndry_lyr, mass_a=mass_a), x_pl)
    gwp_norm = mp.sqrt(g_rr * grad_wp[0] ** 2 + g_thth * grad_wp[1] ** 2
                       + g_pp * grad_wp[2] ** 2)
    grad_wp_n = [g / gwp_norm for g in grad_wp]
    w_prime = (spatial_dot(khat, grad_wp, x_pl, mass_ns)
               + mix * spatial_dot(v_ortho, grad_wp, x_pl, mass_ns))

    grad_kg = _grad3(
        lambda x: k_gamma(x, ks, t, erg_inf_ini, theta_m, omega, b0, r_ns,
                          mass_ns, mass_a, isotropic=isotropic, flat=flat,
                          bndry_lyr=bndry_lyr), x_pl)
    gkg_norm = mp.sqrt(g_rr * grad_kg[0] ** 2 + g_thth * grad_kg[1] ** 2
                       + g_pp * grad_kg[2] ** 2)
    grad_kg_n = [g / gkg_norm for g in grad_kg]
    k_prime = (spatial_dot(khat, grad_kg, x_pl, mass_ns)
               + mix * spatial_dot(v_ortho, grad_kg, x_pl, mass_ns))

    grad_om = _grad3(
        lambda x: omega_function(x, ks, t, theta_m, omega, b0, r_ns, mass_ns,
                                 mass_a, iso=isotropic, bndry_lyr=bndry_lyr),
        x_pl)
    gom_norm = mp.sqrt(g_rr * grad_om[0] ** 2 + g_thth * grad_om[1] ** 2
                       + g_pp * grad_om[2] ** 2)
    grad_om_n = [g / gom_norm for g in grad_om]
    cos_w = abs(spatial_dot(khat, grad_om_n, x_pl, mass_ns))

    def om_of_k(kk):
        return omega_function(x_pl, kk, t, theta_m, omega, b0, r_ns, mass_ns,
                              mass_a, iso=isotropic, bndry_lyr=bndry_lyr)

    v_group = []
    for i in range(3):
        def fi(v, i=i):
            kk = list(ks)
            kk[i] = v
            return om_of_k(kk)
        v_group.append(mp.diff(fi, ks[i]))
    v_group = [v_group[0] / g_rr, v_group[1] / g_thth, v_group[2] / g_pp]
    vg_norm = mp.sqrt(spatial_dot(v_group, v_group, x_pl, mass_ns))
    vg_hat = [v / vg_norm for v in v_group]

    slength = mp.sqrt(1 + (wp**2 / w_erg**2 * st**2
                           / (1 - wp**2 / w_erg**2 * ct**2) * (ct / st)) ** 2)
    if isotropic:
        slength = mp.mpf(1)
    new_guess = (slength / vg_norm) * spatial_dot(khat, grad_om, x_pl, mass_ns)

    dk_vg = abs(spatial_dot(vg_hat, grad_kg_n, x_pl, mass_ns))
    k_vg = abs(spatial_dot(vg_hat, khat, x_pl, mass_ns))
    de_vg = abs(spatial_dot(vg_hat, grad_om_n, x_pl, mass_ns))
    return (abs(w_prime), abs(k_prime), abs(new_guess), cos_w, vg_norm,
            dk_vg, de_vg, k_vg)


def conversion_prob(ax_g, x_pl, ks, t, w_erg, theta_m, omega, b0, r_ns,
                    mass_ns, mass_a, flat=False, isotropic=False,
                    bndry_lyr=-1, one_d=False, wp_mass_a=None):
    """conversion_prob (RayTracer.jl:1405-1473), anisotropic branch.

    local_vars are recomputed exactly as get_Prob_nonAD builds them
    (MainRunner.jl:75-121): Bmag and ctheta_B carry the 1.95e-2 eV^2
    conversion, wp optionally with the default Mass_a=1e-5 (the reference
    omits Mass_a at MainRunner.jl:119 — pass wp_mass_a=1e-5 to reproduce).
    Returns (Prob, |vhat.gradE|, cos_w, |gradE|, cos_w_2, |gradE_2|)."""
    x_pl = _m(x_pl)
    ks = _m(ks)
    w_erg = mp.mpf(w_erg)
    if wp_mass_a is None:
        wp_mass_a = mass_a
    wp = gj_wp(x_pl, t, theta_m, omega, b0, r_ns, zero_in=True,
               bndry_lyr=bndry_lyr, mass_a=wp_mass_a)
    bs = gj_spherical(x_pl, t, theta_m, omega, b0, r_ns, mass_ns, flat=flat)
    bmag = mp.sqrt(spatial_dot(bs, bs, x_pl, mass_ns)) * GAUSS  # eV^2
    kmag = mp.sqrt(spatial_dot(ks, ks, x_pl, mass_ns))
    khat = [k / kmag for k in ks]
    ct = spatial_dot(bs, ks, x_pl, mass_ns) * GAUSS / (kmag * bmag)
    st = mp.sin(mp.acos(ct))
    if isotropic:
        ct = mp.mpf(0)
        st = mp.mpf(1)
    vloc = mp.sqrt(w_erg**2 - mp.mpf(mass_a) ** 2) / w_erg
    rr = x_pl[0]
    erg_inf_ini = mp.sqrt(1 - 2 * GNEW * mp.mpf(mass_ns) / rr / C_KM**2) * w_erg
    _, g_rr, g_thth, g_pp = g_schwartz(x_pl, mass_ns)

    if isotropic:
        dmu_e = _grad3(
            lambda x: omega_function(x, ks, t, theta_m, omega, b0, r_ns,
                                     mass_ns, mass_a, iso=True, kmag=kmag,
                                     bndry_lyr=bndry_lyr), x_pl)
        dmu_e2 = dmu_e
    else:
        (g_rrr, g_rtt, g_rpp, g_trt, g_tpp, g_prp, g_ptp, g_ttr, g_ppr,
         g_ppt) = cristoffel(x_pl, mass_ns)
        dmu_wp = _grad3(
            lambda x: gj_wp(x, t, theta_m, omega, b0, r_ns, zero_in=True,
                            bndry_lyr=bndry_lyr, mass_a=mass_a), x_pl)
        dmu_b = _grad3(
            lambda x: gj_spherical(x, t, theta_m, omega, b0, r_ns, mass_ns,
                                   flat=flat, return_comp=0), x_pl)
        grads_bi = [
            _grad3(lambda x, c=c: gj_spherical(x, t, theta_m, omega, b0, r_ns,
                                               mass_ns, flat=flat,
                                               return_comp=c), x_pl)
            for c in (1, 2, 3)
        ]
        term1 = [ks[0] * grads_bi[0][i] + ks[1] * grads_bi[1][i]
                 + ks[2] * grads_bi[2][i] for i in range(3)]
        term2_r = (ks[0] * (g_rr * bs[0] * GAUSS) * g_rrr
                   + ks[1] * g_trt * (bs[1] * g_thth * GAUSS)
                   + ks[2] * g_prp * (bs[2] * g_pp * GAUSS))
        term2_t = (ks[0] * (g_thth * bs[1] * GAUSS) * g_rtt
                   + ks[2] * g_ptp * (bs[2] * g_pp * GAUSS)
                   + ks[1] * (g_rr * bs[0] * GAUSS) * g_ttr)
        term2_p = (ks[0] * (g_pp * bs[2] * GAUSS) * g_rpp
                   + ks[1] * g_tpp * (bs[2] * g_pp * GAUSS)
                   + ks[2] * g_ppr * (bs[0] * g_rr * GAUSS)
                   + ks[2] * g_ppt * (bs[1] * g_thth * GAUSS))
        dmu_ct = [(term1[i] + [term2_r, term2_t, term2_p][i]) / (kmag * bmag)
                  - ct * dmu_b[i] / bmag for i in range(3)]

        def om_of_k(kk):
            return omega_function(x_pl, kk, t, theta_m, omega, b0, r_ns,
                                  mass_ns, mass_a, iso=isotropic,
                                  bndry_lyr=bndry_lyr)

        v_group = []
        for i in range(3):
            def fi(v, i=i):
                kk = list(ks)
                kk[i] = v
                return om_of_k(kk)
            v_group.append(mp.diff(fi, ks[i]))
        t2r = (g_rrr * ks[0] * (g_rr * v_group[0])
               + g_trt * ks[1] * (g_thth * v_group[1])
               + g_prp * ks[2] * (g_pp * v_group[2]))
        t2t = (g_rtt * ks[0] * (g_thth * v_group[1])
               + g_ptp * ks[2] * (g_pp * v_group[2])
               + g_ttr * ks[1] * (g_rr * v_group[0]))
        t2p = (g_rpp * ks[0] * (g_pp * v_group[2])
               + g_tpp * ks[1] * (g_pp * v_group[2])
               + g_ppr * ks[2] * (g_rr * v_group[0])
               + g_ppt * ks[2] * (g_thth * v_group[1]))
        term2 = [t2r, t2t, t2p]

        pre_f = wp / abs(w_erg**5 + ct**2 * w_erg * (wp**4 - 2 * wp**2 * w_erg**2))
        dmu_e = [pre_f * (w_erg**4 * st**2 * dmu_wp[i]
                          - w_erg**2 * ct * wp * (w_erg**2 - wp**2) * dmu_ct[i])
                 for i in range(3)]
        dmu_e2 = [dmu_e[i] + term2[i] for i in range(3)]

    ge = mp.sqrt(spatial_dot(dmu_e, dmu_e, x_pl, mass_ns))
    ge2 = mp.sqrt(spatial_dot(dmu_e2, dmu_e2, x_pl, mass_ns))
    cos_w = abs(spatial_dot(khat, [d / ge for d in dmu_e], x_pl, mass_ns))
    cos_w_2 = abs(spatial_dot(khat, [d / ge2 for d in dmu_e2], x_pl, mass_ns))
    vhat_grad_e = spatial_dot(khat, dmu_e, x_pl, mass_ns)

    if one_d:
        prob = mp.pi / 2 * (mp.mpf(ax_g) * mp.mpf("1e-9") * bmag) ** 2 / (
            vloc * abs(vhat_grad_e) * C_KM * HBAR)
    else:
        prefactor = w_erg**4 * st**2 / (
            ct**2 * wp**2 * (wp**2 - 2 * w_erg**2) + w_erg**4)
        prob = mp.pi / 2 * prefactor * (mp.mpf(ax_g) * mp.mpf("1e-9") * bmag) ** 2 / (
            abs(vhat_grad_e) * vloc * C_KM * HBAR)
    return prob, abs(vhat_grad_e), cos_w, ge, cos_w_2, ge2


def get_prob_nonad(pos, kpos, mass_a, ax_g, theta_m, omega, b0, r_ns,
                   erg_inf_ini, mass_ns, flat=False, isotropic=False,
                   bndry_lyr=-1):
    """get_Prob_nonAD (MainRunner.jl:67-124): driver-side wrapper.  t = 0;
    the scalar wp uses the DEFAULT Mass_a=1e-5 (Mass_a omitted at the
    GJ_Model_ωp_vecSPH call, MainRunner.jl:119)."""
    pos = _m(pos)
    rr = mp.sqrt(sum(v**2 for v in pos))
    x_pl = [rr, mp.acos(pos[2] / rr), mp.atan2(pos[1], pos[0])]
    ks = k_sphere(pos, kpos, mass_ns, flat=flat)
    erg_ax = mp.mpf(erg_inf_ini) / mp.sqrt(
        1 - 2 * GNEW * mp.mpf(mass_ns) / rr / C_KM**2)
    prob, *_ = conversion_prob(
        ax_g, x_pl, ks, 0.0, erg_ax, theta_m, omega, b0, r_ns, mass_ns,
        mass_a, flat=flat, isotropic=isotropic, bndry_lyr=bndry_lyr,
        one_d=False, wp_mass_a=1e-5)
    return prob


def g_det(x_pl, t, theta_m, omega, b0, r_ns, mass_ns, mass_a, flat=False,
          bndry_lyr=-1):
    """g_det (RayTracer.jl:734-754): sqrt(-g) area-jacobian ratio.
    zeroIn=false in the wp gradient."""
    if flat:
        return mp.mpf(1)
    x_pl = _m(x_pl)
    _, g_rr, _, _ = g_schwartz(x_pl, mass_ns, r_ns=r_ns)
    r = x_pl[0]
    dwp = _grad3(
        lambda x: gj_wp(x, t, theta_m, omega, b0, r_ns, zero_in=False,
                        bndry_lyr=bndry_lyr, mass_a=mass_a), x_pl)
    dr_th = dwp[1] / dwp[0]
    dr_p = dwp[2] / dwp[0]
    s2 = mp.sin(x_pl[1]) ** 2
    det = r * mp.sqrt(s2 * (g_rr * r**2 + dr_th**2) + dr_p**2)
    det_nogr = r * mp.sqrt(s2 * (r**2 + dr_th**2) + dr_p**2)
    return det / det_nogr


def v_infinity(theta, phi, r, vel_loc, v_comp=0, mass_ns=1.0):
    """v_infinity (RayTracer.jl:771-790); v_comp 0-based here."""
    vel_loc = _m(vel_loc)
    vmag = mp.sqrt(sum(v**2 for v in vel_loc))
    gmr = GNEW * mp.mpf(mass_ns) / mp.mpf(r) / C_KM**2
    v_inf = mp.sqrt(vmag**2 - 2 * gmr)
    rhat = [mp.sin(mp.mpf(theta)) * mp.cos(mp.mpf(phi)),
            mp.sin(mp.mpf(theta)) * mp.sin(mp.mpf(phi)),
            mp.cos(mp.mpf(theta))]
    rv = sum(v * rh for v, rh in zip(vel_loc, rhat))
    denom = v_inf**2 + gmr - v_inf * rv
    return (v_inf**2 * vel_loc[v_comp] + v_inf * gmr * rhat[v_comp]
            - v_inf * vel_loc[v_comp] * rv) / denom


def jacobian_fv(x_in, vel_loc, mass_ns=1.0):
    """jacobian_fv (RayTracer.jl:756-769): |det d v_inf / d v_loc|^-1."""
    x_in = _m(x_in)
    vel_loc = _m(vel_loc)
    rmag = mp.sqrt(sum(v**2 for v in x_in))
    phi = mp.atan2(x_in[1], x_in[0])
    theta = mp.acos(x_in[2] / rmag)
    rows = []
    for c in range(3):
        row = []
        for i in range(3):
            def fi(v, i=i, c=c):
                vl = list(vel_loc)
                vl[i] = v
                return v_infinity(theta, phi, rmag, vl, v_comp=c,
                                  mass_ns=mass_ns)
            row.append(mp.diff(fi, vel_loc[i]))
        rows.append(row)
    det = mp.det(mp.matrix(rows))
    return abs(det) ** -1
