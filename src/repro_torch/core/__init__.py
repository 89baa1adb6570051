"""repro_torch.core — the LCMP integer decision core as torch ops.

  tables : control-plane bootstrap vectors (Fig. 3)
  pathq  : Alg. 1/2 + Eq. 2 path-quality scores
  cong   : Q/T/D on-switch congestion estimator (Eqs. 3-5)
  select : Eq. 1 fused cost + diversity-preserving selection (§3.4)
  baselines : the baseline routing laws
  flowcache, switchd : the switch-local object model (Fig. 2): on the
           card one standalone cong_update launch a monitor tick and one
           switch_route call a batch, through launchers bound once per
           switch

Every function is integer-only and bit-exact with ``repro.core`` (the
flow cache on batches whose slots are distinct).
"""
