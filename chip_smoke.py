"""Drive the cgx_torch main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failed check exits nonzero, and no result line is printed):

1. device: the card's name and power limit, the toolchain probe;
2. build: compile the CUDA kernels from ``cgx_torch/csrc`` with nvcc;
3. K1 (stencil SpMV, the march along x) against its plain PyTorch version
   and against its first design (one thread a row, the same-run "before",
   counted nowhere) bit for bit, at 128³ (the float4 form) and at a ragged
   37×41×53 (the scalar form);
4. the main path as a user drives it: three right-hand sides at 128³ and
   one at 224³ through ``cgx_torch.auto_solve`` (routed to the whole-solve
   kernel K2), each answer checked with ``cgx_torch.spmv`` (K1); the
   kernels' launch counters are read around this phase only.  Then each
   solve is held against K2's plain version on the same card and against
   an fp64 solve of the same system, and K2 is run twice to show it is
   bit-reproducible;
5. times (CUDA events, median of interleaved repetitions) of both kernels
   and their plain versions; K1 at 128³ beside its first design in turns:
   device time cold (x rotated over 8 buffers of 8 MB, past the L2) and
   warm (one buffer), by queued events, the host's µs per call (1,000
   calls enqueued behind a spin kernel), and events around 20 calls from
   Python; K2 at 128³ and 224³ (b = ones) equal to the
   three-phase kernel it replaced (kept as the same-run "before", counted
   nowhere) bit for bit at one grid, and timed in turns with it, beside
   the stream floors (``k2_times``);
6. the Jacobi-PCG path over variable-coefficient DIA operators: DIA-7, a
   7-point D·A·D at 192³ (D ~ U[0.5, 2) from seed 0), and DIA-27,
   ``poisson3d_dia27(128, 128, 128, variable=True, seed=0)``, each with
   b = ones and a seeded random b, through ``auto_solve(a, b,
   preconditioner=JacobiPrecond.from_matrix(a))``, routed to
   ``"resident_dia"`` (K2 in planes/weight mode, one launch per solve);
7. the history path: ``track_history=True`` on DIA-7 (``"fused_dia"``)
   and on the 224³ stencil (``"fused_stencil"``), which run the two-pass
   engine K3 (kernels A and B);
8. each solve of 6 and 7 held against its plain version on the card and
   against an fp64 Jacobi-PCG solve of the same system, and K3's solves
   against the same solves through K3's first design (the same-run
   "before", kernel A and B folding each other's partials in every block)
   bit for bit (x, iterations, history) and both timed in turns; K2's
   planes mode and K3 run twice
   to show they are bit-reproducible; K3's kernels A and B each held
   against their plain versions for one step;
9. times of K2's planes mode in fp32 and bf16 planes, each equal to the
   three-phase kernel bit for bit at one grid and timed in turns with it
   (``k2_plane_times``), of K3 and of K3's two kernels, each beside its
   plain version (and K3 A beside torch's CSR product of Ã), K3's kernel
   A and B at DIA-7 192³ against their first design (q and K3's partials,
   or x', r', p' and B's partials, bit for bit; device time per call of
   both in turns; X1 does the same in bf16 vectors at 224³), K3's kernel
   B the same way on the 224³ stencil in fp32 (unweighted), and K2's
   constant mode beside K3 at 224³;
10. W1, the unstructured path's build: the thermal2 stand-in at full size
    (``standin("thermal2")``, 1,228,045 rows, seed 0) through
    ``auto_format``, which must choose WBELL, its tier plan, and the row
    layouts K7, K9 and K8 read (build time, slots, padding, bytes; K8's
    equal to K7's array for array);
11. W2, the WBELL kernels K7 and K9 (k = 1 and 4) and K8 (k = 4) on
    seeded operands, each held against its plain version bit for bit,
    against an fp64 CSR product through the permutation, and against a
    second run; each against the plane walk it replaces and K8 against
    K7 and its plane walk's plain version, bit for bit;
12. W3, the path as a user drives it: ``auto_solve(op, b, tol=1e-6,
    maxiter=8000, preconditioner=...)`` with Jacobi (b = ones and a seeded
    b), none, ``PolynomialPrecond`` and ``"block_jacobi"``, each answer
    checked through K9 (``wbell_spmv(..., backend="windowed")``) and in
    fp64 through the CSR; the Jacobi b = ones solve held against the same
    solve over K7's plain version, on a row layout built apart from the
    kernel's, on the host from the planes;
13. W4, multi-RHS: ``auto_solve(op, B)`` with B (n, 4) under Jacobi (K8),
    each column against a single-RHS solve of it;
14. W5, times: K7 and K9 (k = 1 and 4) and K8 (k = 4), events and device
    time, beside their plain versions, the plane walk they replace (the
    same-run "before"; K8 must beat its own) and torch's CSR product of
    the same matrix, which K7 and K9 at k = 1 must beat; each beside the
    one bound of Y = A·X (the fewest bytes that move it), its own
    layout's bytes and the planes'; µs per iteration of the Jacobi solve;
15. M1, the multi-RHS engine K5: kernels A and B one step each against
    their plain versions at DIA-27 160³ (``poisson3d_dia27(160, 160, 160,
    variable=True, seed=0)`` under Jacobi, 13 symmetric planes) and at the
    224³ stencil, k = 4 seeded columns; each column's q against K3 A's;
    kernel A's march against the first kernel A (the same-run "before"):
    q bit for bit, the sums within 1e-6;
16. M2 and M3, the path as a user drives it: ``auto_solve(a, B)`` with B
    (n, 4) seeded, on DIA-27 160³ with ``JacobiPrecond`` and on the 224³
    stencil (K5 alone), each column against an fp64 solve and its
    single-RHS K3 solve, twice for reproducibility, and against the same
    solve through K5's plain versions;
17. M4, the narrow-band route: DIA-7 192³ with B (n, 4) under Jacobi runs
    K3 per column, each column equal to ``fused_dia_cg`` bit for bit;
18. M5, the batched loop below ``FUSED_MIN_ROWS`` (DIA-27 128³, B (n, 4),
    Jacobi; no kernel), each column against its own ``cg_solve``; then
    ``block_cg_solve`` on the 64³ stencil with 8 clustered right-hand
    sides against single CG;
19. M6, times: K5 per iteration beside the four sequential K3 solves of
    the same B (at DIA-27 160³, the 224³ stencil and the narrow-band DIA-7
    192³ of M4, which ``auto`` sends to K3), K5 A's march and the first
    kernel A in device time per call, in turns, with the march's tile,
    planes a block and grid, the profiler's device time of K5 A and B, one
    call of each beside its plain version and bound, and the PyTorch calls
    that compute K5 A's product (the CSR product of Ã, conv3d with batch
    4);
20. B1, the block-ELL SpMM K11 (``cgx_torch.kernels.bell_spmm``) on the
    JAX package's block-dense record (512 block rows of 8 distinct seeded
    64×64 fp32 blocks, X (32768, k)) at k = 256 and 512, engines
    ``"auto"`` and ``"dma"``: against its plain version and a numpy fp64
    product (1e-5 · max|y|), twice for reproducibility; every launch on
    the ``tiled`` path (K11's path counters);
21. B2, bf16 operands at 1024 block rows, k = 256 (float32 out): against
    its plain version and, within 3e-2 in the 2-norm, the fp32 product;
    on the ``mma`` path;
22. B3, ``poisson3d(128, 128, 128)`` in fp32 through ``bsr_from_csr(·,
    8)`` and ``bell_from_bsr``: ``bell_spmv`` (k = 1) and ``bell_spmm``
    (k = 4) against the CSR ``spmv``/``spmm``; on the ``rows`` path;
23. B4, the path as a user drives it (no kernel): ``auto_solve`` over the
    BSR and COO forms of ``poisson3d(64, 64, 64)`` (route ``"xla"``)
    against an fp64 solve and the CSR solve's count, ``cg_solve_multi``
    over the BSR with B (n, 4) against each column's solve, and the
    legacy 4-line file of ``poisson2d(256, 256)`` written, read back equal,
    and solved (``tol=0``, 50 updates, fp64) on the card against the CPU;
24. after the counts, B1 (k = 256, 512) and B3 (k = 1, 4) each equal to
    K11's general path (its first kernel, forced through its plan) bit for
    bit; then B5, times: K11 in B1–B3 on its path, interleaved with its
    general path, its plain version and torch's BSR product (B3 also
    torch's CSR product), each with its bound and share of the bound; each
    path must beat the general path, and K11 torch's BSR product in B1 and
    B2; then B3's operator at k = 32 (the general path: a tiled block would
    have 4 threads) and k = 64 (tiled), each faster than the other path and
    equal to it bit for bit;
25. X1, mixed precision as a user drives it: ``auto_solve(
    poisson3d_stencil(224, 224, 224), b, mixed_precision=True)`` with b =
    ones and a seeded b, routed to ``ir_cg_solve`` with K3 in bf16 vectors
    (the outer residual from fp32 K3 A, no K2); each answer held against
    the same ``ir_cg_solve`` through the plain versions and against an
    fp64 solve (forward error ≤ 1e-4; the seeded b's fp64 true relres),
    and K3 A and B in bf16 one step each against their plain versions, bit
    for bit; K3 A and B in bf16 vectors and a 100-iteration solve against
    K3's first design bit for bit, each pair timed in turns;
26. X2, the same on DIA-27 160³ and DIA-7 192³ with ``JacobiPrecond``:
    ``bf16_plane_speedup`` chooses the plane mode (bf16 planes, fp32
    vectors), and K3 A in it equals its plain version and fp32 K3 A on the
    planes rounded through bf16, bit for bit; at DIA-27 160³ K3 A and a
    100-iteration solve against K3's first design bit for bit, each pair
    timed in turns;
27. X3, K2 with bf16 planes (``resident_dia_cg(plane_dtype=bf16)``) at
    DIA-27 128³ (to tol) and DIA-7 192³ (100 iterations: its rounded
    operator is indefinite and the solve breaks down): equal to fp32 K2 on
    the pre-rounded planes bit for bit at one grid (the smaller of the two
    instances'), and at DIA-27 to its plain version within K2's bounds;
28. X4, ``fused_dia_cg_multi(DIA-27 160³, B (n, 4), plane_dtype=bf16)``:
    each column equal to fp32 K5 on the pre-rounded planes bit for bit;
29. X5, times: each narrow mode per iteration beside its fp32 mode, its
    plain version and its bound (2 B per bf16 value), the profiler's
    device time per launch, the PyTorch calls computing the same products
    (bf16 conv3d, the CSR product of Ã with bf16-rounded values), K5 A in
    bf16 planes against its first kernel A (q bit for bit, device time in
    turns), IR per
    inner iteration beside the fp32 K3 and K2 solves, and the measured
    fp32/bf16-plane ratio beside ``bf16_plane_speedup``'s prediction (the
    TPU model) at DIA-7 192³, DIA-27 128³ and DIA-27 160³;
30. S1, the semi-resident whole solve K4 as a user drives it:
    ``auto_solve(poisson3d_stencil(160, 160, 160), b,
    backend="sr_stencil")`` (the card's tier plan gives rpq) and
    ``sr_stencil_cg(..., mode=m)`` with rpq at 160³, rp at 216³ and p at
    288³, b = ones and a seeded b; each solve equal to K3's
    (``fused_stencil_cg``) bit for bit and to K4's first design
    (``sr_kernel``, the same-run "before", counted nowhere) bit for bit
    (x, iterations, rw), held against K4's plain version and an fp64
    solve (forward error ≤ 1e-4), and run twice;
31. S2, ``auto_solve(a, b, preconditioner=JacobiPrecond.from_matrix(a),
    backend="sr_dia")`` on the 7-point D·A·D at 160³ and on DIA-27 128³
    (b = ones and seeded), the rp and p tiers forced at DIA-7 160³, and
    bf16 planes at DIA-27 128³ (equal to fp32 K4 on the planes rounded
    through bf16 at one partition); each equal to ``fused_dia_cg`` (K3)
    and to K4's first design bit for bit, and each the kernel its
    instance runs by its launch counters (``sr_kernel`` at DIA-7 rpq,
    ``sr2_kernel`` elsewhere);
32. S3, resume: ``sr_cg_call`` at 160³ stopped after 100 (rpq) or 101
    (rp) iterations and resumed equals one call bit for bit, and so do
    the first design resumed from the same state and in one call;
33. S4, the one-pass engine K6: ``fused_stencil_cg(poisson3d_stencil(224,
    224, 224), b, one_pass=True)`` with b = ones and seeded, with and
    without ``track_history``; each equal to K3's solve (x, iterations,
    history) bit for bit, and to the first K6 design (the same-run
    "before"), held against its plain version and fp64; K6's grid beside
    K3's;
34. S5, times: K4 per iteration in each tier (160³ rpq, 216³ rp, 288³
    p; DIA-7 160³ rpq, rp and p; DIA-27 128³ rpq in fp32 and bf16 planes)
    beside its first design and K3 in turns (events around a solve, one
    launch of K4 each) and K2 on the same system and b, with the kernel
    that ran, the tier's stream floor and K4's grid over K3's; on the DIA
    operators all three on the planes of one ``dia_prep`` (K3 on its
    prepared engine, K2 through ``resident_cg_call``), the prep's own time
    printed apart; K6 beside
    K3 and the
    first K6 design at 224³ in turns, and both K6s' device time per
    iteration (profiler), each beside its plain version and its 6- and
    7-stream floors;
35. E1, the column-stacked WBELL SpMM K10 (``wbell_spmm_stacked``, K7's
    kernel over K7's row layout) on W1's thermal2 operator, k = 4 seeded
    columns: ``from_stacked`` of its Y equal to K7's batched Y, to its
    plain version and to its first design (the plane walk,
    ``_planes_k10``) bit for bit, twice;
36. E2, the tiered single call P1 (``cgx_torch.experiments.tier_proto``):
    ``build_tiers`` on thermal2 (host seconds printed) and its row layout,
    ``tier_spmm`` at k = 1 and 4 equal bit for bit to its plain version,
    to the plane walk's plain version, to the plane walk it replaces and
    to a second run, and within 1e-5 of K7's Y (of the peak);
37. E3, the 4×8 half-blocks P3 (``halfblock_proto``): ``build_halfblock``
    on thermal2 (fill and planes beside the 8×8 build's) and its segmented
    row layout, ``half_spmv`` held as P1 is, and within 1e-5 of the fp64
    CSR product through the permutation;
38. E4, K12 (``bell_spmm(engine="prefetch")``, K11's entry per chunk of
    256 block rows, on K11's path) on B1 (2 chunks, tiled), B2 (bf16, 4,
    mma) and 300 seeded block rows (256 + 44): each equal to K11 bit for
    bit and within 1e-5 of the fp64 product;
39. E5, the paired slots P2 (``bell_pair_proto``, K11's path with two
    slots per round) on B1 and B2: equal to K11 bit for bit; an odd wb
    raises;
40. E6, times (CUDA events, interleaved medians): K10 and P1 beside K7 and
    K8 at k = 4, P1 and P3 beside K7 at k = 1, K12 and P2 beside K11 at B1
    and B2, each beside its plain version, its bound and torch's CSR or
    BSR product of the same matrix; K10 beside its first design and K7 in
    device time, in turns; P1 (k = 1 and 4) and P3 (k = 1) in
    device time too, beside the plane walks they replace, and at k = 1
    below the CSR product's device time;
41. N, the port's native library (``cgx_torch.native``): built with g++
    into a fresh directory (its seconds printed), and a seeded legacy file
    of ``poisson2d(256, 256)`` parsed by it, equal to the numpy parse, to
    the writer's input and to ``read_legacy`` on the card;
42. SR, ``cg_solve_single_reduction``, ``cg_solve_pipelined(
    adaptive_replace=True)`` and the periodic ``cg_solve_pipelined()``
    beside ``cg_solve`` on the 128³ stencil, b = ones and seeded: each
    one's iterations, ``converged``, true relres, forward error against an
    fp64 solve (≤ 1e-4 where converged; the pipelined forms may end on
    their stagnation guard, ``GUARD_EXITS``), ms per solve and µs per
    iteration in turns, host reads (one an iteration), and K1's launches
    against what the recurrences imply (one an iteration, one at the
    start, four a replacement);
43. CH, ``chebyshev_solve`` with ``analytic_bounds`` on the 128³ stencil
    (checked against the closed form), and with ``estimate_bounds`` (a
    generator seeded 0) under Jacobi on DIA-7 192³, capped at 2,000
    iterations; ``estimate_bounds`` on the 128³ stencil beside the
    analytic bounds; the same figures and the host reads (one a check);
44. IC, ``IC0Precond`` natural and multicolor and ``IC0SweepPrecond(
    nsweeps=3)`` on ``poisson3d(128, 128, 128)`` (CSR, fp32): host seconds
    of each set-up step, levels, width and padded gathers, ms per apply
    (events) and its device time (profiler), each apply against the same
    function on a CPU copy (1e-5), and each PCG solve beside Jacobi-PCG
    (natural IC(0) must take fewer iterations).  Each of N, SR, CH and
    IC prints its seconds;
45. HP, the df64 accuracy layer (``cgx_torch.ops.df64``,
    ``cgx_torch.solve.hp``): ``two_prod`` and ``two_sum`` over 2²⁰ seeded
    fp32 pairs with 0 mismatches against the exact fp64 result on the
    card, ``df_dot`` within 2⁻⁴⁶ of an extended-precision dot (and within
    1e-11 under cancellation), ``df64_ell_spmv`` at thermal2 (W1's
    matrix) within 1e-13 of torch's fp64 CSR product and both timed; the
    refinement ``make_ir_df64_solver(inner_format="wbell",
    preconditioner=JacobiPrecond)`` at thermal2, two seeded b, each to a
    TRUE relres ≤ 1.5e-6 in fp64 through K7 (its build on the host clock,
    each solve by events); on the bcsstk17 stand-in (10,974 rows) the
    refinement with an IC(0) and with a Jacobi ELL inner (≤ 1.5e-6),
    fp32 Jacobi-PCG's own true relres, and ``df64_cg_solve(jacobi=True)``
    capped at 20,000 iterations (converged implies ≤ 1.5·tol); after NF,
    ``make_ir_df64_solver_multi`` at thermal2 on the loaded bundle, k = 4
    seeded columns, each to ≤ 1.5e-6 through K8;
46. NF, the native format: the thermal2 operator bundle saved and loaded
    (size and both times), the prebuilt solver's x equal to the fresh
    one's bit for bit, and ``save_matrix``/``load_matrix`` of the
    bcsstk17 stand-in's WBELL and of DIA-7 64³ (every array and the
    product bit for bit);
47. CK, checkpointed solves (``cgx_torch.utils.checkpoint``, chunks of
    100, seeded b): ``"xla"`` and K2 (``"resident"``) on the 128³ stencil,
    K3 (``"fused"``) on DIA-7 192³ under Jacobi, K4 (``"sr"``, tier rpq)
    on the 160³ stencil, each equal to its monolithic solve bit for bit
    and timed beside it; each preempted after two chunks and resumed from
    its file (bit for bit where the state is unscaled; within 1e-5 and one
    iteration for K3's Jacobi-scaled state); a K3 snapshot resumed under
    ``"xla"`` within 1e-4 of ``cg_solve``; one snapshot write timed;
    each preempted run's file holds k = 200, the resumed run's first
    chunk ends at k = 300 and its kernel's launches are the chunked
    solve's less the preempted run's;
48. PF, profiling (``cgx_torch.utils.profiling``), run right after 3 in a
    child process of its own (``python3 chip_smoke.py --profiling-phase``,
    its own CUDA context: a CPU and CUDA profiler session leaves this
    process's later CUDA-only sessions reading no device time):
    ``trace`` around one K2 solve at 128³, ``trace_report`` naming K2's
    kernel with a device time, printed beside ``queued_ms`` of the same
    solve, and ``overlap_report``.  Each of HP, NF, CK and PF prints its
    seconds.  Every profiler figure of the result line must be above 0;
49. D, distribution (``cgx_torch.dist``, after IC), on an NCCL group of one
    rank formed on a free localhost port (one card: NCCL refuses two
    ranks on one card): ``dist_fused_cg`` on the 224³ stencil (b = ones,
    history) and on DIA-7 192³ under Jacobi, ``dist_fused_cg_multi`` on
    DIA-27 160³ under Jacobi with B (n, 4), each equal to its single-card
    solve bit for bit, one all-reduce after every kernel launch
    (``halo.counters``); ``dist_cg_solve`` on DIA-7 128³ under Jacobi
    against ``cg_solve``; the CUDA K3 A and K5 A of shard r of 4, ghost
    planes cut from the neighbouring shards, against the whole grid's q
    bit for bit, and their cross-rank kernel B against the plain
    versions; the distributed engines' µs per iteration beside the
    single-card ones in turns, and one all-reduce's host and device µs;
50. DW1, on D's group (``dist_wbell_phases``): ``partition_wbell(thermal2,
    4)`` built globally and per shard (host seconds; the per-shard build's
    planes are the global build's), and for each shard r of 4, K7 over
    shard r's row layout, its halo group slabs cut from the whole internal
    x (``halo.cut_halo_rows``, no traffic), equal to its rows of the whole
    matrix's K7 product bit for bit, and K8 at k = 4 over the shard's tier
    plan (holding the shard's K7 layout) to its rows of the whole K8
    product;
51. DW2, ``dist_wbell_cg_solve`` (Jacobi, a seeded b) and
    ``dist_wbell_cg_solve_multi`` (k = 4, K8) on thermal2 through one NCCL
    rank, each held beside ``wbell_cg_solve`` / ``wbell_cg_solve_multi``
    (iterations within 1 %, x within 1e-4), with K7's and K8's launches,
    the collectives (two all-reduces an iteration, the one all-gather at
    the boundary) and the row layouts built (none) read around the first
    run, and µs per iteration of both in turns;
52. DW3, ``make_dist_ir_df64_solver`` (Jacobi, two seeded b) and
    ``make_dist_ir_df64_solver_multi`` (k = 4) on thermal2 over DW2's
    partition, each to a TRUE relres ≤ 1.5e-6 in fp64, their outer cycles,
    inner iterations and seconds beside HP's single-card figures;
53. CLI, after the group is destroyed: ``python -m cgx_torch`` in
    subprocesses: ``solve --poisson 128x128x128 --format stencil`` (K2's
    iterations in process), ``solve --input`` NF's thermal2 bundle under
    Jacobi, ``bench`` of the 128³ stencil (one JSON line on the route
    ``select_backend`` gives in process), ``info``, each exiting 0, and
    ``solve --devices 2``, which exits non-zero and names torchrun.  Each
    of DW1–DW3 and CLI prints its seconds;
54. SC, on D's group before it is destroyed (``cgx_torch.bench.scaling``):
    ``comm_report`` of ``partition_dia`` of DIA-7 192³ at 4 shards under
    the card's ``LinkModel``, ``measure_scaling`` of DIA-7 128³ at the
    group's one rank (its iterations ``cg_solve``'s), and the one-rank
    costs ``LinkModel`` quotes: an all-reduce of one fp64 word and an
    all-gather of 4 KiB, CUDA events around 100 calls;
55. SS, the SuiteSparse sweep (``cgx_torch.bench.suitesparse``):
    ``bench_matrix("thermal2", W1's CSR, fmt="auto", reps=1)``, all four
    preconditioners (none, jacobi and block_jacobi on WBELL through K7,
    ic0 on CSR; each converged, none with an error; the jacobi row's
    iterations those of one unchunked ``cg_solve``), then ``main(["--names",
    "bcsstk17", "--escalate-df64", "--reps", "1"])``, each fp32 row that
    did not converge carrying a df64 record at TRUE relres ≤ 1.5·tol;
56. DR, the warm df64 run per right-hand side
    (``cgx_torch.bench.df64_rhs``): ``python -m cgx_torch.bench.df64_rhs
    --name thermal2 --rhs 1`` (its build and TRUE-residual checks) in a
    child process beside SS, then in process ``--multi 4 --operator`` NF's
    bundle (K8), and ``--multi 4 --operator`` a missing path, which exits
    non-zero;
57. RF, the reference program's full-size problem
    (``cgx_torch.bench.reference_full``): ``build_full_problem()`` (n =
    52,269, 345 diagonals), 31 fp32 updates on the card against a float64
    numpy CG of the same updates (rel < 1e-3), and ``main`` against the
    compiled reference where its tree is present;
58. GE, ``cgx_torch.graft_entry.entry()`` on the card: converged, ‖r‖ ≤
    1e-5·‖b‖.  Each of SC, SS, DR, RF and GE prints its seconds, and the
    whole run's seconds are printed last on the standard error.

The launch counters are set to 0 just before each of the paths 4, 6, 7,
W3–W4, M2–M5, B1–B4, X1–X4, S1, S2, S4, E1–E5, SR, CH, HP, CK, PF,
D1–D3, DW2, DW3, SS's thermal2 sweep and DR's ``--multi`` run, and read
just after it (K1's entry gives SR's and CH's as
``solver_launches``; HP's, CK's and PF's launches are the keys
``hp_launches``, ``ck_launches`` and ``pf_launches`` of K1's, K2's, K3's,
K4's, K7's and K8's entries; D's are ``dist_launches`` on the K3 A/B and
K5 A/B entries, with ``dist_us_per_iter`` beside ``single_us_per_iter``,
and DW2's and DW3's ``dist_launches`` on K7's and K8's, with DW2's µs per
iteration; SS's are ``ss_launches`` on K7's entry, DR's ``dr_launches``
on K8's).  The line before the last
is a JSON object describing each kernel, with its bound (the larger of
its bytes, each input read once and each output written once, over 3.35
TB/s, and its operations over 67 TFLOP/s fp32, or 989 TFLOP/s on the
tensor cores for bf16 operands) and the time of one PyTorch call that
computes the same function where there is one (K7–K10, P1 and P3, which
compute one function, Y = A·X, take one bound: the fewest bytes that move
it, ``wbell_least_bytes``); the last line is
``{"ok": true, "device": {...}}``; K1's entry gives its device time
cold and warm (``device_ms``, ``warm_device_ms``), its host µs per call
(``host_us``) and its first design's (``before_ms`` by events,
``before_device_ms``, ``before_host_us``), K10's its device time beside
its first design's and K7's; K11's entry there also names its path
at B1 and its launches by path; the entries of K3 A and B and of K5 A
give device time (``ms``) beside that of their first design, measured in
turns in the same run (``before_ms``), and K4's entries their solve time
beside the first K4 design's: ``sr_cg`` at 160³ rpq, ``sr_cg_planes`` (the
redesign's planes mode) at DIA-27 128³ rpq and ``sr_cg_first`` (the first
design, the kernel of DIA-7 rpq) at DIA-7 160³ rpq.  Needs one CUDA
card; it imports
neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 0
N128 = (128, 128, 128)
N224 = (224, 224, 224)
N192 = (192, 192, 192)
N160 = (160, 160, 160)
N216 = (216, 216, 216)
N288 = (288, 288, 288)
K_MULTI = 4               # right-hand sides of the multi-RHS phases
TOL = 1e-6
JAX_ITERS_ONES_128 = 300  # the JAX package's count (BENCH_r05.json)
MAXIT_HIST = 5000         # maxiter of the history solves
# The JAX package's iteration counts on the thermal2 stand-in to 1e-6 on
# the TPU (BASELINE.md:120,163): a trajectory fact, not a speed figure.
TPU_ITERS_THERMAL2 = {"none": 5543, "jacobi": 3466}
MAXIT_WBELL = 8000
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, fp32 FLOP/s outside
# the tensor cores, dense bf16 FLOP/s on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
# Cycles of the spin kernel that holds the card while the host enqueues
# the calls :func:`queued_ms` times (~10 ms at the H100's clock).
SPIN_CYCLES = 20_000_000
# x buffers K1's cold timing rotates over: 8 × 8 MB at 128³, past the L2.
K1_COLD_BUFFERS = 8
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
# The block-sparse phases: the JAX package's block-dense records
# (BASELINE.md:79-80, docs/PERF_NOTES.md round 5g), bs 64 and wb 8.
BELL_BS = 64
BELL_WB = 8
BELL_ROWS = {"B1": 512, "B2": 1024}   # block rows
N64 = (64, 64, 64)                   # B4's solves
LEGACY_2D = (256, 256)               # B4's legacy file


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS):
    """``(ms, "bytes" | "operations")``: the least time the card could
    take for the work, the larger of the two (operations at ``peak``)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0 and proc.stdout.strip() != "",
          f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def event_ms(fn, inner: int = 1) -> float:
    """ms per call of ``fn`` over ``inner`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(inner):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / inner


def time_pair(kernel, plain, reps: int = 7, inner: int = 1):
    """Median ms per call of ``kernel`` and ``plain``, interleaved."""
    return tuple(time_set([kernel, plain], reps, inner))


def time_set(fns, reps: int = 5, inner: int = 1):
    """Median ms per call of each of ``fns``, interleaved: each repetition
    runs them all, in reverse order every other time."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for i in range(reps):
        order = range(len(fns)) if i % 2 == 0 else reversed(range(len(fns)))
        for j in order:
            times[j].append(event_ms(fns[j], inner))
    return [statistics.median(t) for t in times]


def queued_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """ms of device time per call of ``fn``, for a function that does not
    read the host mid-call: CUDA events around ``calls`` calls that wait
    on the card behind a spin kernel (~10 ms), so the host has enqueued
    them all before the first runs and the card runs them back to back.
    A repetition counts only if the spin was still running when the last
    call was enqueued; else it runs again with twice the spin, and fails
    after three doublings.  Median of ``reps``.  Unlike :func:`device_ms`
    it needs no profiler records."""
    fn()
    torch.cuda.synchronize()
    times, spin = [], SPIN_CYCLES
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(calls):
            fn()
        queued = not start.query()
        end.record()
        end.synchronize()
        if queued:
            times.append(start.elapsed_time(end) / calls)
        else:
            check(spin < SPIN_CYCLES * 8, "queued_ms: the card ran out of "
                  f"queued work behind a spin of {spin} cycles")
            spin *= 2
    return statistics.median(times)


def device_ms(fn, calls: int = 20) -> float:
    """ms of device time per call of ``fn``: every kernel's time under
    torch.profiler (CUDA activity only) over ``calls`` calls, the host's
    gaps between them left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A session now and then records no kernel at all; such a session is
    # run again, and three empty sessions fail the smoke.
    for session in range(1, 4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = device_us(prof, lambda key: True)[0]
        if us > 0:
            break
        print(f"device_ms: profiler session {session} recorded no device "
              f"time", file=sys.stderr)
    check(us > 0, "device_ms: the profiler recorded no device time")
    return us / calls / 1e3


def in_turns(fns, reps: int = 4):
    """Median device ms per call of each of ``fns`` (:func:`queued_ms`),
    timed in turns: a, b, …, then …, b, a."""
    ms = [[] for _ in fns]
    for i in range(reps):
        order = range(len(fns)) if i % 2 == 0 else reversed(range(len(fns)))
        for j in order:
            ms[j].append(queued_ms(fns[j]))
    return [statistics.median(m) for m in ms]


def rotating(fn, xs):
    """A call of ``fn`` on the next of ``xs`` each time, round and round:
    with their sum past the 50 MB L2, every call reads its x cold."""
    it = itertools.cycle(xs)
    return lambda: fn(next(it))


def host_us(fn, calls: int = 1000) -> float:
    """µs of host time per call of ``fn``: ``calls`` calls enqueued behind
    a spin kernel (~20 ms) and timed by the host clock, so the clock reads
    the enqueue, not the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(2 * SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def k1_times(card, fns, xs, plain=None, reps: int = 4):
    """K1's four figures for each of ``fns`` ({name: f(x)}), in turns: the
    device time per call cold (x rotated over ``xs``, whose sum exceeds the
    L2) and warm (``xs[0]`` alone), both by :func:`queued_ms`; the host µs
    per call (:func:`host_us`); and CUDA events around 20 calls from
    Python on ``xs[0]`` (the figure the kernel table kept before the
    other three), beside ``plain`` where given.  Returns ``{name: {"cold_ms", "warm_ms", "host_us",
    "events_ms"}}``."""
    names = list(fns)
    cold = in_turns([rotating(fns[nm], xs) for nm in names], reps)
    warm = in_turns([lambda f=fns[nm]: f(xs[0]) for nm in names], reps)
    hosts = [[] for _ in names]
    for i in range(reps):
        order = range(len(names)) if i % 2 == 0 else reversed(
            range(len(names)))
        for j in order:
            hosts[j].append(host_us(lambda f=fns[names[j]]: f(xs[0])))
    calls = [lambda f=fns[nm]: f(xs[0]) for nm in names]
    if plain is not None:
        calls.append(lambda: plain(xs[0]))
    events = time_set(calls, reps=5, inner=20)
    out = {nm: {"cold_ms": cold[j], "warm_ms": warm[j],
                "host_us": statistics.median(hosts[j]),
                "events_ms": events[j]} for j, nm in enumerate(names)}
    if plain is not None:
        out["plain"] = {"events_ms": events[-1]}
    labels = {"cold_ms": "device cold", "warm_ms": "device warm",
              "host_us": "host", "events_ms": "events"}
    for nm, v in out.items():
        print(f"[{card}] K1 {nm}: " + ", ".join(
            f"{labels[key]} {val if key == 'host_us' else val * 1e3:.2f} us"
            for key, val in v.items()))
    return out


def k3a_launcher(eng, p, design):
    """A zero-argument launch of K3's kernel A on ``p`` in its x0 mode,
    its arguments built once (``design``: the redesign or the first
    design, the same-run "before"), and the ``q`` and partials it writes.
    Launch counters count neither."""
    from cgx_torch.kernels import _build

    lib, ga, _ = eng._setup(p)
    q = torch.empty_like(p)
    part = torch.empty(2 * ga, dtype=torch.float64, device=p.device)
    args = eng._a_args(p, q, part, ga, None, 1, None, None, init=1,
                       design=design)
    return (lambda: _build.check(lib.cgx_fused_a(*args), "K3 A launch"),
            q, part)


def k3a_versus_first(tag, label, eng, p, card):
    """K3's redesigned kernel A against the first one on ``p``: q and K3's
    partials bit for bit (checked), then the device time per call of both
    in turns.  Returns ``(ms, first design's ms)``."""
    from cgx_torch.kernels import fused_engine as k3

    new, q1, part1 = k3a_launcher(eng, p, k3._REDESIGN)
    old, q0, part0 = k3a_launcher(eng, p, k3._FIRST_DESIGN)
    new()
    old()
    torch.cuda.synchronize()
    same = torch.equal(q1, q0) and torch.equal(part1, part0)
    t_new, t_old = in_turns([new, old])
    print(f"[{card}] {tag} K3 A {label}: equal to the first kernel A bit "
          f"for bit (q and {part0.shape[0]} partials): {same}; device "
          f"{t_new * 1e3:.2f} us per call, the first {t_old * 1e3:.2f} us "
          f"({t_new / t_old:.3f}), in turns")
    check(same, f"{tag} {label}: K3's kernel A differs from its first design")
    return t_new, t_old


def k3b_versus_first(tag, label, eng, card, rz, pq, qq, x, r, p, q):
    """K3's redesigned kernel B (p·q and q·q from the control block, its
    partials folded once a launch, in bf16 its rows loaded ahead of its
    stores: ``fused_engine.B_ROWS``) against the first one (every block
    folding A's partials) for one step from ``rz, pq, qq`` on copies of
    ``x, r, p``: x', r', p' and B's partials bit for bit (checked), then
    the device time per call of both in turns.  Returns ``(ms, first
    design's ms)``."""
    from cgx_torch.kernels import _build
    from cgx_torch.kernels import fused_engine as k3

    fns, outs = [], []
    for design in (k3._REDESIGN, k3._FIRST_DESIGN):
        lib, args, out = eng._kernel_b_setup(rz, pq, qq, x, r, p, q, design)
        fns.append(lambda lib=lib, args=args: _build.check(
            lib.cgx_fused_b(*args), "K3 B launch"))
        outs.append(out)
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    check(not torch.equal(outs[0][0], x), f"{tag} {label}: kernel B left "
          "x as it was")
    t_new, t_old = in_turns(fns)
    print(f"[{card}] {tag} K3 B {label} ({k3.B_ROWS[eng.dtype]} rows in "
          f"flight): "
          f"equal to the first "
          f"kernel B bit for bit (x', r', p' and its partials): {same}; device "
          f"{t_new * 1e3:.2f} us per call, the first {t_old * 1e3:.2f} us "
          f"({t_new / t_old:.3f}), in turns")
    check(same, f"{tag} {label}: K3's kernel B differs from its first design")
    return t_new, t_old


def k3_solve_versus_first(tag, label, eng, b, **kw):
    """A K3 solve through the redesigned kernels against the first
    design's: x, iterations and history bit for bit (checked), then both
    timed in turns (CUDA events around a solve, medians of 3).  Returns
    ``(µs per iteration, the first design's)``."""
    from cgx_torch.kernels import fused_engine as k3

    new = eng.solve(b, track_history=True, **kw)
    old = k3._before_solve(eng, b, track_history=True, **kw)
    its = int(new.iterations)
    same = (its == int(old.iterations) and torch.equal(new.x, old.x)
            and torch.equal(new.history, old.history))
    t_new, t_old = time_pair(
        lambda: eng.solve(b, track_history=True, **kw),
        lambda: k3._before_solve(eng, b, track_history=True, **kw), reps=3)
    us_new, us_old = t_new / its * 1e3, t_old / its * 1e3
    print(f"{tag} K3 solve {label} ({its} iterations): x, iterations and "
          f"history equal to the first design's: {same}; {us_new:.2f} us "
          f"per iteration, the first design {us_old:.2f} "
          f"({us_new / us_old:.3f}), in turns")
    check(same, f"{tag} {label}: the K3 solve differs from its first design")
    return us_new, us_old


def k5a_versus_first(tag, label, eng, p, card):
    """K5's march against its first kernel A on ``p``: q bit for bit and
    the sums within 1e-6 (checked), the device time per call of both in
    turns, the plan.  Returns ``(ms, first design's ms)``."""
    from cgx_torch.kernels import fused_multi as k5

    check(eng.a_design() == k5._MARCH,
          f"{tag} {label}: K5 A does not take the march")
    new, q1, _ = k5._kernel_a_launcher(eng, p, k5._MARCH)
    old, q0, g0 = k5._kernel_a_launcher(eng, p, k5._FIRST_DESIGN)
    new()
    old()
    torch.cuda.synchronize()
    same = torch.equal(q1, q0)
    t_new, t_old = in_turns([new, old])
    mp = eng.march
    print(f"[{card}] {tag} K5 A {label}, k={p.shape[0]}: the march (tile "
          f"{mp.tj} x {mp.tk}, {mp.rows} a thread, {mp.length} planes a "
          f"block, grid {mp.grid}, {mp.smem_bytes} B shared) equal to the "
          f"first kernel A (grid {g0}) in q bit for bit: {same}; device "
          f"{t_new * 1e3:.2f} us per call, the first {t_old * 1e3:.2f} us "
          f"({t_new / t_old:.3f}), in turns")
    check(same, f"{tag} {label}: K5's march differs from its first kernel A")
    return t_new, t_old


def rhs_set(dims, dev):
    """The right-hand sides of the main path: ones (as bench.py), a seeded
    random one, and a smooth one."""
    nx, ny, nz = dims
    n = nx * ny * nz
    rng = np.random.default_rng(SEED)
    ix = (np.arange(1, nx + 1) / (nx + 1))
    iy = (np.arange(1, ny + 1) / (ny + 1))
    iz = (np.arange(1, nz + 1) / (nz + 1))
    smooth = np.einsum("i,j,k->ijk", ix * (1 - ix), iy * (1 - iy),
                       iz * (1 - iz)).reshape(-1)
    return {
        "ones": torch.ones(n, dtype=torch.float32, device=dev),
        "random": torch.from_numpy(
            rng.standard_normal(n).astype(np.float32)).to(dev),
        "smooth": torch.from_numpy(smooth.astype(np.float32)).to(dev),
    }


def true_relres(a, b, x) -> float:
    """‖b − A·x‖/‖b‖ in fp64 with the plain operator."""
    b64, x64 = b.double(), x.double()
    r = b64 - a.matvec(x64)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


def rel(u, v) -> float:
    """‖u − v‖/‖v‖ (fp64)."""
    u, v = u.double(), v.double()
    return float(torch.linalg.vector_norm(u - v) / torch.linalg.vector_norm(v))


def scaled_dia7(dims, dev):
    """DIA-7: D·A·D of the 7-point Poisson DIA with D ~ U[0.5, 2) from
    SEED (the construction of tests/test_kernels.py:161-174), fp32."""
    from cgx_torch.io.poisson import poisson3d_dia
    from cgx_torch.sparse.types import DIAMatrix

    a = poisson3d_dia(*dims, device="cpu")
    n = a.shape[0]
    d = np.random.default_rng(SEED).uniform(0.5, 2.0, n)
    data = a.data.numpy()
    for k, off in enumerate(a.offsets):
        tgt = np.arange(n) + off
        ok = (tgt >= 0) & (tgt < n)
        data[k, ok] *= d[ok] * d[tgt[ok]]
    return DIAMatrix(data=torch.from_numpy(data.astype(np.float32)).to(dev),
                     offsets=a.offsets, shape=a.shape, grid=a.grid)


def hold(label, x, its, x_ref, its_ref, relres, relres_ref, fwd, fwd_ref):
    """The bounds every kernel solve is held to against its plain version
    (x_ref, its_ref, relres_ref) and an fp64 solve (fwd = forward error).
    Where the plain version itself misses the forward-error bound, the
    kernel is held to 1.5× the plain version's and a note is printed."""
    dx = rel(x, x_ref)
    print(f"{label}: iterations {its} (plain {its_ref}), true relres (fp64) "
          f"{relres:.3e} (plain {relres_ref:.3e}), |x-x_plain|/|x_plain| "
          f"{dx:.3e}, |x-x64|/|x64| {fwd:.3e} (plain {fwd_ref:.3e})")
    check(abs(its - its_ref) <= 2,
          f"{label}: {its} vs plain {its_ref} iterations")
    check(dx <= 1e-4, f"{label}: x differs from the plain version by {dx}")
    check(relres <= 1.5 * relres_ref,
          f"{label}: true relres {relres} vs plain {relres_ref}")
    bound = 1e-4
    if fwd_ref > 1e-4:
        bound = 1.5 * fwd_ref
        print(f"{label}: the plain version's forward error {fwd_ref:.3e} "
              f"exceeds 1e-4; the kernel is held to 1.5x it")
    check(fwd <= bound, f"{label}: forward error {fwd} (bound {bound})")
    return dx


def maxrel(y, ref) -> float:
    """Max-norm relative difference (fp64)."""
    y, ref = y.double(), ref.double()
    return float((y - ref).abs().max() / ref.abs().max())


def wbell_io_bytes(op, k) -> int:
    """x read and y written once, k fp32 columns of the internal layout."""
    return 2 * k * op.nt * 1024 * 4


def wbell_least_bytes(a, op, k) -> int:
    """The fewest bytes that move Y = A·X for k columns of the WBELL
    operator ``op`` of ``a``: the smaller row layout's (K7's, K9's) or the
    nonzeros' alone (8 B each), x read and y written once.  K7–K10, P1 and
    P3 compute this one function, so all take this one bound."""
    return min(op.rows.call_bytes(k), op.windowed_rows.call_bytes(k),
               a.nnz * 8 + wbell_io_bytes(op, k))


def wbell_bound(a, op, k):
    """``bound()`` of Y = A·X: the fewest bytes, 2 flops a nonzero."""
    return bound(wbell_least_bytes(a, op, k), 2 * a.nnz * k)


def floor_us(streams, n) -> float:
    """µs to move ``streams`` vectors of ``n`` floats at the HBM rate."""
    return streams * 4 * n / HBM_BYTES_PER_S * 1e6


def us_of(nbytes) -> float:
    """µs to move ``nbytes`` at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e6


def wbell_phases(dev, card):
    """W1–W5: the unstructured path at the thermal2 stand-in's full size.
    Returns the kernels' entries of the report line and ``(a, op, plan)``:
    the CSR matrix, its WBELL operator and tier plan, for E1–E3."""
    import cgx_torch
    from cgx_torch.io.suitesparse import standin
    from cgx_torch.kernels import wbell as kw
    from cgx_torch.sparse.wbell import group_walk, row_layout

    # -- W1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    a = standin("thermal2", seed=SEED)
    t_standin = time.perf_counter() - t0
    n = a.shape[0]
    t0 = time.perf_counter()
    op, fmt = cgx_torch.auto_format(a)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    check(fmt == "wbell", f"auto_format chose {fmt!r} for thermal2")
    kept7 = int(op.resident_walk[0].numel())
    n_planes = int(op.values.shape[0])
    print(f"W1 thermal2 stand-in: {n} rows, {a.nnz} nnz, built in "
          f"{t_standin:.1f} s; auto_format -> {fmt} in {t_build:.1f} s: "
          f"{n_planes} planes ({kept7} non-zero), nt {op.nt}, ngw "
          f"{op.ngw}, span {op.span}, wbcap {op.wbcap}, "
          f"{op.outg.shape[0]} virtual tiles, fill "
          f"{op.nnz_stored / a.nnz:.2f}x, planes + lc "
          f"{n_planes * 65 * 128 * 4 / 1e6:.1f} MB")
    layouts = {}
    for name, attr in (("K7", "rows"), ("K9", "windowed_rows")):
        t0 = time.perf_counter()
        rows = getattr(op, attr)
        torch.cuda.synchronize()
        layouts[name] = rows
        print(f"W1 row layout ({name}): built from the planes on the card in "
              f"{time.perf_counter() - t0:.3f} s; {rows.slots} slots for "
              f"{rows.nnz} nonzeros (padding {rows.slots / rows.nnz:.3f}x), "
              f"{rows.nbytes / 1e6:.1f} MB, "
              f"{16 if rows.cols.dtype == torch.int16 else 32}-bit columns, "
              f"{int(rows.sptr[-1])} stages, widest window {rows.window} "
              f"floats")
        check(rows.nnz == a.nnz, f"{name}'s row layout holds {rows.nnz} of "
              f"{a.nnz} nonzeros")
    # The tier plan, as each multi-RHS solve builds it: its time and the
    # card memory it adds (its class-major planes; the row layout it holds
    # is the matrix's).
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = kw.build_tier_plan(op)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    kept8 = int(plan.walk[0].numel())
    print(f"W1 tier plan (built per multi-RHS solve): {t_plan:.3f} s, holds "
          f"{held / 1e6:.1f} MB on the card (peak {peak / 1e6:.1f} MB while "
          f"built), steps {plan.steps} x {plan.splane}; its row layout is "
          f"the matrix's: {plan.rows is op.rows}")
    check(plan.rows is op.rows, "the tier plan does not hold K7's layout")
    # Why it may: its planes in its own walk give K7's arrays.
    own = kw.tiered_rows(plan.packed, plan.lc, plan.values, plan.walk,
                         plan.nt)
    same = all(torch.equal(getattr(own, f), getattr(layouts["K7"], f))
               for f in ("values", "cols", "sbase", "rowmap", "sptr", "x0",
                         "xlen"))
    del own
    print(f"W1 the row layout of K8's tier plan (its planes in its own walk) "
          f"equals K7's array for array: {same}")
    check(same, "K8's row layout differs from K7's")
    layouts["K8"] = plan.rows

    # -- W2. the kernels against their plain versions ----------------------
    rng = np.random.default_rng(SEED)
    xs = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32)).to(
        dev)
    xi = torch.stack([op.to_internal(xs[:, c]) for c in range(4)])
    a64 = torch.sparse_csr_tensor(a.indptr, a.col_indices, a.values.double(),
                                  size=a.shape, check_invariants=False)
    y64 = a64 @ xs.double()
    k7_rows, k8_rows, k9_rows = layouts["K7"], layouts["K8"], layouts["K9"]
    cases = {
        "K7 k=1": (lambda: kw.wbell_spmm(op, xi[:1]),
                   lambda: kw.rows_product(k7_rows, xi[:1]), 1),
        "K7 k=4": (lambda: kw.wbell_spmm(op, xi),
                   lambda: kw.rows_product(k7_rows, xi), 4),
        "K9 k=1": (lambda: kw.wbell_spmm(op, xi[:1], backend="windowed"),
                   lambda: kw.rows_product(k9_rows, xi[:1]), 1),
        "K9 k=4": (lambda: kw.wbell_spmm(op, xi, backend="windowed"),
                   lambda: kw.rows_product(k9_rows, xi), 4),
        "K8 k=4": (lambda: kw.wbell_spmm_tiered(plan, xi),
                   lambda: kw.rows_product(k8_rows, xi), 4),
    }
    # The plane walks that K7, K8 and K9 replace: their same-run "before".
    planes = {"K7": kw._planes_k7, "K9": kw._planes_k9,
              "K8": lambda _, x: kw._planes_k8(plan, x)}
    errs, ys = {}, {}
    for label, (run, plain, k) in cases.items():
        y = run()
        torch.cuda.synchronize()
        y_ref = plain()
        again = run()
        torch.cuda.synchronize()
        ys[label] = y
        e_plain = maxrel(y, y_ref)
        y_std = torch.stack([op.from_internal(y[c]) for c in range(k)], 1)
        e64 = maxrel(y_std, y64[:, :k])
        errs[label] = float((y - y_ref).abs().max())
        print(f"W2 {label}: max|y - plain| / max|plain| {e_plain:.3e} "
              f"(bitwise equal: {torch.equal(y, y_ref)}), vs fp64 CSR "
              f"{e64:.3e}, two runs bitwise equal: {torch.equal(y, again)}")
        check(e_plain <= 1e-5, f"{label} disagrees with its plain version")
        check(e64 <= 1e-5, f"{label} disagrees with the fp64 CSR product")
        check(torch.equal(y, again), f"{label}: two runs differ")
        if label[:2] in planes:
            before = planes[label[:2]](op, xi[:k].contiguous())
            torch.cuda.synchronize()
            print(f"W2 {label}: equal to the plane walk it replaces bit for "
                  f"bit: {torch.equal(y, before)}")
            check(torch.equal(y, y_ref), f"{label} is not bitwise equal to "
                  "its plain version")
            check(torch.equal(y, before), f"{label} differs from the plane "
                  "walk")
    y8_walk = kw.wbell_tiered_reference(plan, xi)
    print(f"W2 K8 k=4 equal to its plane walk's plain version bit for bit: "
          f"{torch.equal(ys['K8 k=4'], y8_walk)}")
    check(torch.equal(ys["K8 k=4"], y8_walk), "K8 differs from its plane "
          "walk's plain version")
    print(f"W2 K8 k=4 equal to K7 k=4 bit for bit: "
          f"{torch.equal(ys['K8 k=4'], ys['K7 k=4'])}")
    check(torch.equal(ys["K8 k=4"], ys["K7 k=4"]), "K8 differs from K7")

    # -- W3. the path as a user drives it -----------------------------------
    b_ones = torch.ones(n, dtype=torch.float32, device=dev)
    b_rand = torch.from_numpy(np.random.default_rng(SEED + 1)
                              .standard_normal(n).astype(np.float32)).to(dev)
    jac = cgx_torch.JacobiPrecond.from_matrix(a.astype(torch.float32))
    poly = cgx_torch.PolynomialPrecond.from_matrix(op)
    solves = [("jacobi", "ones", jac, b_ones), ("jacobi", "random", jac,
                                                 b_rand),
              ("none", "ones", None, b_ones), ("poly", "ones", poly, b_ones),
              ("block_jacobi", "ones", "block_jacobi", b_ones)]

    def relres64(b, x):
        r = b.double() - (a64 @ x.double()[:, None])[:, 0]
        return float(torch.linalg.vector_norm(r)
                     / torch.linalg.vector_norm(b.double()))

    kw.wbell_resident_launches = kw.wbell_tiered_launches = 0
    kw.wbell_windowed_launches = 0
    results = {}
    for name, bn, m, b in solves:
        route = cgx_torch.select_backend(op, b, m)
        check(route == "wbell", f"thermal2 {name} routed to {route}")
        before = kw.wbell_resident_launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = cgx_torch.auto_solve(op, b, tol=TOL, maxiter=MAXIT_WBELL,
                                   preconditioner=m)
        end.record()
        end.synchronize()
        its = int(res.iterations)
        spmvs = kw.wbell_resident_launches - before
        want = 3 * its + 2 if name == "poly" else its
        # The answer checked as a user checks it: the residual through K9.
        r32 = op.to_internal(b) - kw.wbell_spmv(op, op.to_internal(res.x),
                                                backend="windowed")
        rel32 = float(torch.linalg.vector_norm(r32)
                      / torch.linalg.vector_norm(b))
        rr64 = relres64(b, res.x)
        results[name, bn] = (res, its, rr64, start.elapsed_time(end))
        tpu = TPU_ITERS_THERMAL2.get(name)
        print(f"W3 {name} b={bn}: {its} iterations"
              + (f" (the JAX package on the TPU: {tpu})" if tpu and bn ==
                 "ones" else "")
              + f", converged {bool(res.converged)}, {spmvs} K7 launches, "
              f"true relres (fp64) {rr64:.3e}, relres via K9 (fp32) "
              f"{rel32:.3e}, {start.elapsed_time(end):.1f} ms")
        check(bool(res.converged), f"thermal2 {name} b={bn} did not converge")
        check(spmvs == want, f"{name}: {spmvs} K7 launches for {want} SpMVs")

    # The Jacobi b = ones solve over K7's plain version, on the card, over
    # a row layout built on the host from the planes (walk included), apart
    # from the cached one K7 reads.
    res, its, rr64, _ = results["jacobi", "ones"]
    idi = op.to_internal(jac.inv_diag)
    t0 = time.perf_counter()
    host = {f: getattr(op, f).cpu() for f in ("values", "lc", "p_og", "p_ga")}
    keep = host["values"].reshape(len(host["values"]), -1).ne(0).any(1)
    host_rows = row_layout(host["values"], host["lc"],
                           group_walk(host["p_og"], keep, op.nt),
                           host["p_og"], host["p_ga"], op.nt)
    plain_rows = dataclasses.replace(host_rows, **{
        f.name: getattr(host_rows, f.name).to(dev)
        for f in dataclasses.fields(host_rows)
        if isinstance(getattr(host_rows, f.name), torch.Tensor)})
    print(f"W3 plain solve's row layout built on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = cgx_torch.cg_solve(
        lambda v: kw.rows_product(plain_rows, v[None])[0],
        op.to_internal(b_ones), tol=TOL, maxiter=MAXIT_WBELL,
        preconditioner=lambda r: r * idi)
    end.record()
    end.synchronize()
    plain_solve_ms = start.elapsed_time(end)
    its_ref = int(ref.iterations)
    x_ref = op.from_internal(ref.x)
    rr64_ref = relres64(b_ones, x_ref)
    # The fp64 Jacobi-PCG solution of the same system, for the forward
    # error (torch's fp64 CSR product as the operator).
    sol64 = cgx_torch.cg_solve(
        lambda v: (a64 @ v[:, None])[:, 0], b_ones.double(), tol=1e-10,
        maxiter=40000, track_history=True,
        preconditioner=cgx_torch.JacobiPrecond(jac.inv_diag.double()))
    x64 = sol64.x
    k64 = int(torch.nonzero(sol64.history <= TOL ** 2 * n)[0, 0])
    fwd, fwd_ref = rel(res.x, x64), rel(x_ref, x64)
    print(f"W3 jacobi b=ones against the plain version: {its} vs {its_ref} "
          f"iterations, true relres {rr64:.3e} vs {rr64_ref:.3e}, x bitwise "
          f"equal: {torch.equal(res.x, x_ref)}; |x-x64|/|x64| {fwd:.3e} "
          f"(plain {fwd_ref:.3e}); the fp64 Jacobi-PCG recurrence reaches "
          f"1e-6 at iteration {k64}")
    check(abs(its - its_ref) <= 0.03 * its_ref, "jacobi: iterations differ "
          "from the plain version's by more than 3 %")
    check(rr64 <= 2 * rr64_ref, f"jacobi: true relres {rr64} (plain "
          f"{rr64_ref})")
    # At b = ones the solution is large and smooth, and b - A·x of its fp32
    # copy cancels: the true relres sits near 0.8 for the kernel and the
    # plain version alike (0.774 on an H100).  The answer is held by
    # its forward error against the fp64 solve instead, and the 2e-3 bound
    # on the true relres by the seeded b, whose solution fp32 holds.
    check(fwd <= 1e-4, f"jacobi b=ones: forward error {fwd}")
    rr_rand = results["jacobi", "random"][2]
    check(rr_rand <= 2e-3, f"jacobi b=random: true relres {rr_rand}")

    # -- W4. multi-RHS --------------------------------------------------------
    B = torch.from_numpy(np.random.default_rng(SEED + 2).standard_normal(
        (n, 4)).astype(np.float32)).to(dev)
    before = kw.wbell_tiered_launches
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    multi = cgx_torch.auto_solve(op, B, tol=TOL, maxiter=MAXIT_WBELL,
                                 preconditioner=jac)
    end.record()
    end.synchronize()
    k8_spmms = kw.wbell_tiered_launches - before
    its_m = [int(v) for v in multi.iterations]
    print(f"W4 multi-RHS k=4 (Jacobi, K8): iterations {its_m}, {k8_spmms} "
          f"K8 launches, {start.elapsed_time(end):.1f} ms")
    check(k8_spmms == max(its_m), "W4 did not run K8 once per iteration")
    for j in range(4):
        one = cgx_torch.auto_solve(op, B[:, j].contiguous(), tol=TOL,
                                   maxiter=MAXIT_WBELL, preconditioner=jac)
        its1 = int(one.iterations)
        print(f"W4 column {j}: {its_m[j]} iterations, single-RHS {its1}, "
              f"converged {bool(multi.converged[j])}, x equal to the "
              f"single solve's: {torch.equal(one.x, multi.x[:, j])}, true "
              f"relres {relres64(B[:, j], multi.x[:, j]):.3e}")
        check(bool(multi.converged[j]), f"W4 column {j} did not converge")
        check(abs(its_m[j] - its1) <= 0.03 * its1,
              f"W4 column {j}: {its_m[j]} vs {its1} iterations")
    launches = {"k7": kw.wbell_resident_launches,
                "k8": kw.wbell_tiered_launches,
                "k9": kw.wbell_windowed_launches}
    print(f"W3-W4 launches: K7 {launches['k7']}, K8 {launches['k8']}, K9 "
          f"{launches['k9']}")
    check(min(launches.values()) > 0, f"a WBELL kernel did not run on the "
          f"path: {launches}")

    # -- W5. times ------------------------------------------------------------
    a32 = torch.sparse_csr_tensor(a.indptr, a.col_indices,
                                  a.values.float(), size=a.shape,
                                  check_invariants=False)
    x1, x4 = xs[:, 0].contiguous(), xs
    xk = {1: xi[:1].contiguous(), 4: xi.contiguous()}
    csr = {1: lambda: a32 @ x1, 4: lambda: a32 @ x4}
    ms, before_ms, csr_ms, dev_ms = {}, {}, {}, {}
    for label, (run, plain, k) in cases.items():
        walk = (lambda f=planes[label[:2]], x=xk[k]: f(op, x))
        got = time_set([run, plain, csr[k], walk], reps=5, inner=10)
        ms[label], csr_ms[label] = (got[0], got[1]), got[2]
        before_ms[label] = got[3]
        # Device time alone: one call from Python costs the card's host
        # about as long as K7 runs.  Kernel, plain version (the profiler's:
        # it reads the host), the plane walk, the CSR product (queued
        # behind a spin kernel), and the kernel under the profiler.
        dev_ms[label] = [queued_ms(run), device_ms(plain), queued_ms(walk),
                         queued_ms(csr[k]), device_ms(run)]
    kept = {"K7": kept7, "K9": kept7, "K8": kept8}
    for label, (t_k, t_p) in ms.items():
        k = cases[label][2]
        io = wbell_io_bytes(op, k)
        least = wbell_least_bytes(a, op, k)
        own = layouts[label[:2]].call_bytes(k)
        walk_bytes = kept[label[:2]] * (65 * 128 * 4 + 8) + io
        d_k, d_p, d_b, d_c, d_prof = dev_ms[label]
        print(f"[{card}] W5 {label}: {t_k * 1e3:.1f} us (plain "
              f"{t_p * 1e3:.1f} us); torch CSR product "
              f"{csr_ms[label] * 1e3:.1f} us; the plane walk it replaces "
              f"{before_ms[label] * 1e3:.1f} us; bound {us_of(least):.1f} us "
              f"({least / 1e6:.1f} MB, the least of the two row layouts and "
              f"the nonzeros alone); its own layout {us_of(own):.1f} us "
              f"({own / 1e6:.1f} MB), the planes' {us_of(walk_bytes):.1f} "
              f"us ({walk_bytes / 1e6:.1f} MB), the nonzeros' alone "
              f"{us_of(a.nnz * 8 + io):.1f} us "
              f"({(a.nnz * 8 + io) / 1e6:.1f} MB); device time per call "
              f"(queued events): {d_k * 1e3:.1f} us (the profiler's "
              f"{d_prof * 1e3:.1f}), plain {d_p * 1e3:.1f} us (profiler), "
              f"the plane walk {d_b * 1e3:.1f} us, the CSR product "
              f"{d_c * 1e3:.1f} us")
    check(dev_ms["K8 k=4"][0] < dev_ms["K8 k=4"][2], f"W5 K8 k=4: device "
          f"time {dev_ms['K8 k=4'][0] * 1e3:.1f} us is not below its plane "
          f"walk's ({dev_ms['K8 k=4'][2] * 1e3:.1f} us)")
    for label in ("K7 k=1", "K9 k=1"):
        check(ms[label][0] < csr_ms[label], f"W5 {label}: "
              f"{ms[label][0] * 1e3:.1f} us is not faster than torch's CSR "
              f"product ({csr_ms[label] * 1e3:.1f} us)")
        check(dev_ms[label][0] < dev_ms[label][3], f"W5 {label}: device "
              f"time {dev_ms[label][0] * 1e3:.1f} us is not below the CSR "
              f"product's ({dev_ms[label][3] * 1e3:.1f} us)")
    its_j = results["jacobi", "ones"][1]
    t_solve = statistics.median(
        event_ms(lambda: cgx_torch.auto_solve(
            op, b_ones, tol=TOL, maxiter=MAXIT_WBELL, preconditioner=jac))
        for _ in range(3))
    print(f"[{card}] W5 Jacobi b=ones: {t_solve:.1f} ms/solve, "
          f"{t_solve / its_j * 1e3:.1f} us/iter ({its_j} it); over the plain "
          f"version {plain_solve_ms:.1f} ms, "
          f"{plain_solve_ms / its_ref * 1e3:.1f} us/iter ({its_ref} it)")
    # W4's solve beside the same solve with the plane walk K8 replaced as
    # its SpMM (equal products, so the same trajectory): the same-run
    # "before" of the multi-RHS solve.
    from cgx_torch.solve import wbell as solve_wbell

    def w4_solve():
        return cgx_torch.auto_solve(op, B, tol=TOL, maxiter=MAXIT_WBELL,
                                    preconditioner=jac)

    def w4_planes():
        keep = solve_wbell.wbell_spmm_tiered
        solve_wbell.wbell_spmm_tiered = lambda p_, x: kw._planes_k8(
            p_, x.to(p_.vector_dtype).contiguous())
        try:
            return w4_solve()
        finally:
            solve_wbell.wbell_spmm_tiered = keep

    t_w4, t_w4p = time_pair(w4_solve, w4_planes, reps=2)
    print(f"[{card}] W5 W4's multi-RHS solve (k=4, Jacobi, {max(its_m)} "
          f"iterations): {t_w4:.1f} ms over K8's row layout, {t_w4p:.1f} ms "
          f"over the plane walk it replaced; {t_w4 / max(its_m) * 1e3:.1f} "
          f"vs {t_w4p / max(its_m) * 1e3:.1f} us/iter")

    # Where the solve's time goes: the kernels' own device time under
    # torch.profiler (CUDA activity only: recording the host's ops slows the
    # host-bound loop several-fold), against the unprofiled solve's event
    # time above, which runs the same bitwise trajectory.
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cgx_torch.auto_solve(op, b_ones, tol=TOL, maxiter=MAXIT_WBELL,
                             preconditioner=jac)
        torch.cuda.synchronize()
    dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
              if e.self_device_time_total > 0}
    busy = sum(dev_us.values())
    k7_us = sum(v for k, v in dev_us.items() if "wbell" in k)
    others = sorted(((round(v / 1e3, 1), k[:40]) for k, v in dev_us.items()
                     if "wbell" not in k), reverse=True)[:6]
    if busy == 0:
        print("W5 profiler: no device time recorded (times above are from "
              "CUDA events)")
    else:
        print(f"[{card}] W5 profiler, one Jacobi b=ones solve: device busy "
              f"{busy / 1e3:.1f} ms of the {t_solve:.1f} ms solve (idle "
              f"share {1 - busy / 1e3 / t_solve:.1%}), K7 "
              f"{k7_us / 1e3:.1f} ms ({k7_us / busy:.1%} of device time, "
              f"{k7_us / its_j:.1f} us/launch); other kernels (ms) "
              f"{others}")

    entries = []
    for name, label, key, src, k in (
            ("wbell_resident", "K7 k=1", "k7", 105, 1),
            ("wbell_tiered", "K8 k=4", "k8", 275, 4),
            ("wbell_windowed", "K9 k=1", "k9", 46, 1)):
        b_ms, b_by = wbell_bound(a, op, k)
        entry = {
            "name": name, "route": "cuda",
            "source": "cgx_torch/csrc/wbell.cu",
            "replaces": f"cgx/kernels/wbell.py:{src}",
            "launches": launches[key], "max_abs_err": errs[label],
            "ms": ms[label][0], "plain_ms": ms[label][1], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": csr_ms[label]}
        # The same three calls in device time: the event time holds the
        # host's enqueue as well.
        d_k, d_p, _, d_c, _ = dev_ms[label]
        entry.update(device_ms=d_k, device_plain_ms=d_p,
                     device_library_ms=d_c)
        entries.append(entry)
    return entries, (a, op, plan)


def seeded_block(n, k, seed, dev):
    """A seeded (n, k) fp32 block of right-hand sides."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, k)).astype(np.float32)).to(dev)


def multi_engine(a, m):
    """K5's engine for a stencil (``m`` None) or for a DIA operator under
    the Jacobi scaling of ``m``, and the scaling vector (None: stencil)."""
    from cgx_torch.kernels.fused_cg import stencil_taps
    from cgx_torch.kernels.fused_dia_cg import dia_prep
    from cgx_torch.kernels.fused_multi import FusedCGMulti

    if m is None:
        nx, ny, nz, taps, coeffs = stencil_taps(a)
        return FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs), None
    nx, ny, nz, taps, coeffs, planes, e, w, sym = dia_prep(
        a, torch.float32, inv_diag=m.inv_diag)
    return FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs, planes=planes,
                        weight=w, sym=sym), e


def scaled_csr(a, e):
    """Ã = E·A·E of a DIA operator as a torch CSR tensor on its device,
    each value rounded as the DIA preparation rounds it."""
    n = a.shape[0]
    dev = a.data.device
    rows = torch.arange(n, device=dev)
    cols = rows[:, None] + torch.tensor(a.offsets, device=dev)[None, :]
    vals = a.data.T * e[:, None] * e[cols.clamp(0, n - 1)]
    keep = (cols >= 0) & (cols < n) & (vals != 0)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(keep.sum(dim=1), 0)
    return torch.sparse_csr_tensor(crow, cols[keep], vals[keep], size=(n, n),
                                   check_invariants=False)


def multi_phases(dev, card, dias):
    """M1–M6: the multi-RHS path over stencils and DIA.  Returns K5's
    entries of the report line."""
    import cgx_torch
    from cgx_torch.io.poisson import poisson3d_dia27
    from cgx_torch.kernels import fused_engine as k3
    from cgx_torch.kernels import fused_multi as k5
    from cgx_torch.kernels import fused_resident as k2
    from cgx_torch.kernels.fused_cg import fused_stencil_cg
    from cgx_torch.kernels.fused_dia_cg import fused_dia_cg
    from cgx_torch.solve.block import _multi_route

    k = K_MULTI
    t0 = time.perf_counter()
    d160 = poisson3d_dia27(*N160, variable=True, seed=SEED, device=dev)
    dias["DIA-27 160^3"] = d160          # the mixed-precision phases' too
    cells = {"DIA-27 160^3": (d160, cgx_torch.JacobiPrecond.from_matrix(
                 d160)),
             "stencil 224^3": (cgx_torch.poisson3d_stencil(*N224), None)}
    print(f"M DIA-27 160^3 built in {time.perf_counter() - t0:.1f} s")

    def zero():
        k5.multi_a_launches = k5.multi_b_launches = 0
        k3.fused_a_launches = k3.fused_b_launches = 0
        k2.resident_cg_launches = k2.resident_dia_launches = 0

    def counts():
        return {"k5_a": k5.multi_a_launches, "k5_b": k5.multi_b_launches,
                "k3_a": k3.fused_a_launches, "k3_b": k3.fused_b_launches,
                "k2": k2.resident_cg_launches + k2.resident_dia_launches}

    def relmax(g, r):
        return float(((g - r).abs() / r.abs()).max())

    # -- M1. K5's kernels one step each, at both cells' full shapes ----------
    errs = {"a": 0.0, "b": 0.0}
    steps = {}
    for label, (a, m) in cells.items():
        eng, e = multi_engine(a, m)
        one = k3.FusedCG(eng.nx, eng.ny, eng.nz, eng.taps, coeffs=eng.coeffs,
                         planes=eng.planes, weight=eng.weight, sym=eng.sym)
        p = seeded_block(eng.n, k, SEED + 3, dev).T.contiguous()   # (k, n)
        q, pq, qq = eng.kernel_a(p)
        torch.cuda.synchronize()
        q_ref, pq_ref, qq_ref = eng.kernel_a_reference(p)
        as_k3 = all(torch.equal(q[j], one.kernel_a(p[j])[0])
                    for j in range(k))
        rel_a = maxrel(q, q_ref)
        rel_as = max(relmax(pq, pq_ref), relmax(qq, qq_ref))
        rz = torch.sum(p.double() ** 2, dim=1).float()
        z = torch.zeros_like(p)
        out = eng.kernel_b(rz, pq_ref, qq_ref, z, p, p, q_ref)
        torch.cuda.synchronize()
        out_ref = eng.kernel_b_reference(rz, pq_ref, qq_ref, z, p, p, q_ref)
        rel_b = max(maxrel(g, r) for g, r in zip(out[:3], out_ref[:3]))
        rel_bs = max(relmax(g, r) for g, r in zip(out[3:], out_ref[3:]))
        n_pl = 0 if eng.planes is None else eng.planes.shape[0]
        print(f"M1 {label} (k={k}, {len(eng.taps)} taps, {n_pl} planes, sym "
              f"{eng.sym}): A max|q-plain|/max|plain| {rel_a:.3e} (bitwise "
              f"{torch.equal(q, q_ref)}), sums {rel_as:.3e}, each column's q "
              f"equal to K3 A's: {as_k3}; B max|x,r,p-plain|/max|plain| "
              f"{rel_b:.3e}, sums {rel_bs:.3e}")
        check(rel_a <= 1e-6 and rel_as <= 1e-5 and as_k3,
              f"M1 {label}: K5 A disagrees")
        # The march against the first kernel A (the same-run "before",
        # counted nowhere) and the plain version: q bit for bit, the sums
        # in another fixed order within 1e-6.
        q0, pq0, qq0 = k5._before_kernel_a(eng, p)
        torch.cuda.synchronize()
        rel_first = max(relmax(pq, pq0), relmax(qq, qq0))
        print(f"M1 {label}: K5 A's march equal bit for bit in q to the "
              f"first kernel A {torch.equal(q, q0)} and to the plain "
              f"version {torch.equal(q, q_ref)}; sums within "
              f"{rel_first:.3e} of the first kernel A's")
        check(torch.equal(q, q0) and torch.equal(q, q_ref)
              and rel_first <= 1e-6 and rel_as <= 1e-6,
              f"M1 {label}: K5's march differs from its first kernel A")
        check(rel_b <= 1e-6 and rel_bs <= 1e-5, f"M1 {label}: K5 B disagrees")
        errs["a"] = max(errs["a"], float((q - q_ref).abs().max()))
        errs["b"] = max(errs["b"], max(float((g - r).abs().max())
                                       for g, r in zip(out[:3], out_ref[:3])))
        steps[label] = (eng, e, one, p, q_ref, pq_ref, qq_ref, rz)

    # -- M2, M3. The path as a user drives it -------------------------------
    launches = {"a": 0, "b": 0}
    main_runs = {}
    for tag, (label, (a, m)) in zip(("M2", "M3"), cells.items()):
        n = a.shape[0]
        B = seeded_block(n, k, SEED + 4, dev)
        route = _multi_route(a, B, m, "auto")[0]
        check(route == "fused", f"{tag} {label} routed to {route}")
        zero()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = cgx_torch.auto_solve(a, B, tol=TOL, preconditioner=m)
        end.record()
        end.synchronize()
        c = counts()
        print(f"{tag} {label} launches: K5 A {c['k5_a']}, K5 B {c['k5_b']}, "
              f"K3 A {c['k3_a']}, K3 B {c['k3_b']}, K2 {c['k2']}")
        check(c["k5_a"] > 0 and c["k5_b"] > 0 and c["k3_a"] == 0
              and c["k3_b"] == 0 and c["k2"] == 0,
              f"{tag}: the path did not run through K5 alone: {c}")
        launches["a"] += c["k5_a"]
        launches["b"] += c["k5_b"]
        its_all = res.iterations.tolist()
        its = its_all[0]
        check(len(set(its_all)) == 1, f"{tag}: iterations {its_all}")
        check(bool(res.converged.all()), f"{tag}: not every column converged")
        # The fp64 (Jacobi-)PCG solution of each column, for the forward
        # error: the batched loop in fp64.
        a64 = a if m is None else a.astype(torch.float64)
        m64 = None if m is None else cgx_torch.JacobiPrecond.from_matrix(a64)
        x64 = cgx_torch.cg_solve_multi(a64, B.double(), tol=1e-10,
                                       maxiter=20000, preconditioner=m64,
                                       backend="xla").x
        fwd = [rel(res.x[:, j], x64[:, j]) for j in range(k)]
        # Each column alone through K3, with the multi solve's cap.
        singles = [(fused_stencil_cg(a, B[:, j].contiguous(), tol=TOL,
                                     maxiter=n) if m is None else
                    fused_dia_cg(a, B[:, j].contiguous(), tol=TOL, maxiter=n,
                                 inv_diag=m.inv_diag)) for j in range(k)]
        its1 = [int(s.iterations) for s in singles]
        last = its1.index(max(its1))
        last_equal = torch.equal(res.x[:, last], singles[last].x)
        dev_last = rel(res.x[:, last], singles[last].x)
        again = cgx_torch.auto_solve(a, B, tol=TOL, preconditioner=m)
        same = (torch.equal(again.x, res.x)
                and torch.equal(again.iterations, res.iterations))
        eng, e = multi_engine(a, m)
        b2 = B.T if e is None else B.T * e[None]
        ref = eng.solve_reference(b2, tol=TOL, maxiter=n)
        x_ref = ref.x if e is None else ref.x * e[:, None]
        its_ref = int(ref.iterations[0])
        dx = rel(res.x, x_ref)
        print(f"{tag} {label}, B ({n}, {k}): {its} iterations shared, "
              f"{start.elapsed_time(end):.1f} ms; single-RHS K3 counts "
              f"{its1}; column {last} (exits last) equal to its single "
              f"solve bit for bit: {last_equal} (|dx|/|x| {dev_last:.3e}); "
              f"|x-x64|/|x64| per column "
              f"{[float(f'{v:.3e}') for v in fwd]}; reproducible: {same}; "
              f"plain version {its_ref} iterations, |x-x_plain|/|x_plain| "
              f"{dx:.3e} (bitwise {torch.equal(res.x, x_ref)})")
        check(max(fwd) <= 1e-4, f"{tag}: forward error {max(fwd)}")
        check(abs(its - max(its1)) <= 2,
              f"{tag}: {its} shared vs single counts {its1}")
        check(same, f"{tag}: two runs differ")
        check(its_ref == its, f"{tag}: {its} vs plain {its_ref} iterations")
        check(dx <= 1e-5, f"{tag}: x differs from the plain version by {dx}")
        main_runs[label] = (B, its, its1, start.elapsed_time(end))

    # -- M4. The narrow-band route: K3 per column ---------------------------
    a7 = dias["DIA-7 192^3"]
    m7 = cgx_torch.JacobiPrecond.from_matrix(a7)
    n7 = a7.shape[0]
    B7 = seeded_block(n7, k, SEED + 5, dev)
    route = _multi_route(a7, B7, m7, "auto")[0]
    check(route == "sequential", f"M4 DIA-7 routed to {route}")
    zero()
    res7 = cgx_torch.auto_solve(a7, B7, tol=TOL, preconditioner=m7)
    torch.cuda.synchronize()
    c = counts()
    print(f"M4 DIA-7 192^3 launches: K3 A {c['k3_a']}, K3 B {c['k3_b']}, "
          f"K5 A {c['k5_a']}, K5 B {c['k5_b']}, K2 {c['k2']}")
    check(c["k3_a"] > 0 and c["k3_b"] > 0 and c["k5_a"] == 0
          and c["k5_b"] == 0 and c["k2"] == 0,
          f"M4: the narrow-band route did not run K3 alone: {c}")
    for j in range(k):
        one = fused_dia_cg(a7, B7[:, j].contiguous(), tol=TOL, maxiter=n7,
                           inv_diag=m7.inv_diag)
        eq = (int(one.iterations) == int(res7.iterations[j])
              and torch.equal(one.x, res7.x[:, j]))
        print(f"M4 column {j}: {int(res7.iterations[j])} iterations, "
              f"converged {bool(res7.converged[j])}, equal to fused_dia_cg "
              f"bit for bit: {eq}")
        check(eq and bool(res7.converged[j]), f"M4 column {j} differs")

    # -- M5. The batched loop below FUSED_MIN_ROWS; block CG ----------------
    a27 = dias["DIA-27 128^3"]
    m27 = cgx_torch.JacobiPrecond.from_matrix(a27)
    B27 = seeded_block(a27.shape[0], k, SEED + 6, dev)
    route = _multi_route(a27, B27, m27, "auto")[0]
    check(route == "xla", f"M5 DIA-27 128^3 routed to {route}")
    zero()
    t0 = time.perf_counter()
    res27 = cgx_torch.auto_solve(a27, B27, tol=TOL, preconditioner=m27)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    c = counts()
    check(sum(c.values()) == 0, f"M5: the loop launched a kernel: {c}")
    for j in range(k):
        one = cgx_torch.cg_solve(a27, B27[:, j].contiguous(), tol=TOL,
                                 preconditioner=m27)
        dxj = rel(res27.x[:, j], one.x)
        print(f"M5 column {j}: {int(res27.iterations[j])} iterations (its "
              f"own cg_solve {int(one.iterations)}), |dx|/|x| {dxj:.3e} "
              f"(bitwise {torch.equal(res27.x[:, j], one.x)})")
        check(int(one.iterations) == int(res27.iterations[j]) and dxj <= 1e-5
              and bool(res27.converged[j]), f"M5 column {j} differs")
    print(f"M5 batched loop DIA-27 128^3, k={k}: {t_loop:.2f} s (host "
          f"clock), no K2, K3 or K5 launch")
    s64 = cgx_torch.poisson3d_stencil(64, 64, 64)
    rng = np.random.default_rng(SEED + 7)
    base = rng.standard_normal(s64.shape[0])
    b8 = torch.from_numpy(np.stack(
        [base + 0.05 * rng.standard_normal(s64.shape[0]) for _ in range(8)],
        axis=1).astype(np.float32)).to(dev)
    blk = cgx_torch.block_cg_solve(s64, b8, tol=1e-5)
    single = cgx_torch.cg_solve(s64, b8[:, 0].contiguous(), tol=1e-5)
    its_blk = int(blk.iterations[0])
    print(f"M5 block_cg_solve 64^3, 8 clustered right-hand sides: {its_blk} "
          f"iterations, converged {blk.converged.tolist()}; single CG on "
          f"column 0: {int(single.iterations)}")
    check(bool(blk.converged.all()) and its_blk < int(single.iterations),
          "M5: block CG did not beat single CG")

    # -- M6. Times -----------------------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    def versus_k3(label, eng, one, b2, its, its1):
        """K5 against the four sequential K3 solves of the same block, in
        turns; returns K5's ms per solve."""
        n = eng.n
        cols = [b2[j] for j in range(k)]
        t5, t3 = time_pair(
            lambda: eng.solve(b2, tol=TOL, maxiter=n),
            lambda: [one.solve(c, tol=TOL, maxiter=n) for c in cols],
            reps=3)
        print(f"[{card}] M6 {label}, k={k}: K5 {t5:.2f} ms/solve, "
              f"{t5 / its * 1e3:.2f} us/iter ({its} it), "
              f"{t5 / its / k * 1e3:.2f} us per column and iteration; four "
              f"sequential K3 solves {t3:.2f} ms, "
              f"{t3 / sum(its1) * 1e3:.2f} us per column and iteration "
              f"({sum(its1)} column-iterations); K5 / K3 "
              f"{(t5 / (its * k)) / (t3 / sum(its1)):.3f}")
        return t5

    dev_ms, per_call, bounds, first_a = {}, {}, {}, {}
    for label, (a, m) in cells.items():
        eng, e, one, p, q_ref, pq_ref, qq_ref, rz = steps[label]
        B, its, its1, _ = main_runs[label]
        n = eng.n
        b2 = (B.T if e is None else B.T * e[None]).contiguous()
        cols = [b2[j] for j in range(k)]
        t5 = versus_k3(label, eng, one, b2, its, its1)
        first_a[label] = k5a_versus_first("M6", label, eng, p, card)
        # The kernels' own device time over one solve (CUDA activity only).
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.solve(b2, tol=TOL, maxiter=n)
            torch.cuda.synchronize()
        us = {ev.key: ev.self_device_time_total for ev in prof.key_averages()
              if ev.self_device_time_total > 0}
        busy = sum(us.values())
        ka = sum(v for kk, v in us.items() if "multi_a2<" in kk)
        kb = sum(v for kk, v in us.items() if "multi_b" in kk)
        if ka == 0 or kb == 0:
            print("M6 profiler: no device time for K5 recorded; per-call "
                  "times below are one call from Python")
        else:
            dev_ms[label] = (ka / its / 1e3, kb / its / 1e3)
            print(f"[{card}] M6 profiler, one K5 solve {label}: device busy "
                  f"{busy / 1e3:.2f} ms of {t5:.2f} (idle share "
                  f"{1 - busy / 1e3 / t5:.1%}); K5 A {ka / its:.2f} us and "
                  f"K5 B {kb / its:.2f} us of device time per iteration "
                  f"({(ka + kb) / busy:.1%} of the device time)")
        # K3's kernels over one column's solve, to set K5's per-column
        # cost beside them.
        j = its1.index(max(its1))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            one.solve(cols[j], tol=TOL, maxiter=n)
            torch.cuda.synchronize()
        us = {ev.key: ev.self_device_time_total for ev in prof.key_averages()}
        k3a = sum(v for kk, v in us.items() if "kernel_a2<" in kk)
        k3b = sum(v for kk, v in us.items() if "kernel_b2<" in kk)
        if k3a and k3b:
            print(f"[{card}] M6 profiler, K3 on column {j} of {label}: A "
                  f"{k3a / its1[j]:.2f} us and B {k3b / its1[j]:.2f} us of "
                  f"device time per iteration; K5 A / K3 A "
                  f"{ka / its / (k3a / its1[j]):.2f}, K5 B / K3 B "
                  f"{kb / its / (k3b / its1[j]):.2f} at k = {k}")
        # One call each from Python beside its plain version.
        z = torch.zeros_like(p)
        t_a, t_ap = time_pair(lambda: eng.kernel_a(p),
                              lambda: eng.kernel_a_reference(p), inner=10)
        t_b, t_bp = time_pair(
            lambda: eng.kernel_b(rz, pq_ref, qq_ref, z, p, p, q_ref),
            lambda: eng.kernel_b_reference(rz, pq_ref, qq_ref, z, p, p,
                                           q_ref), inner=10)
        per_call[label] = (t_a, t_ap, t_b, t_bp)
        # Bounds: A reads the planes and P and writes Q (2 flops per tap
        # and mirror, 4 for the sums); B reads X, R, P, Q and w and writes
        # X, R, P (12 flops per entry).
        n_pl = 0 if eng.planes is None else eng.planes.shape[0]
        terms = sum(2 if (c is None and eng.sym and tap != (0, 0, 0)) else 1
                    for tap, c in zip(eng.taps, eng.coeffs))
        bounds[label] = (
            bound((n_pl + 2 * k) * 4 * n, k * n * (2 * terms + 4)),
            bound((7 * k + (eng.weight is not None)) * 4 * n, 12 * k * n))
        print(f"[{card}] M6 {label} one call from Python: K5 A "
              f"{t_a * 1e3:.2f} us (plain {t_ap * 1e3:.2f} us, bound "
              f"{bounds[label][0][0] * 1e3:.2f} us, {bounds[label][0][1]}; "
              f"device {first_a[label][0] * 1e3:.2f} us, the first kernel A "
              f"{first_a[label][1] * 1e3:.2f} us), "
              f"K5 B {t_b * 1e3:.2f} us (plain {t_bp * 1e3:.2f} us, bound "
              f"{bounds[label][1][0] * 1e3:.2f} us, {bounds[label][1][1]}; "
              f"the call copies X, R, P first)")

    # The narrow-band DIA-7 of M4, which auto sends to K3 per column by the
    # JAX package's plane count (_narrow_band): K5 on the same B, checked
    # and timed against the four K3 solves.
    eng7, e7 = multi_engine(a7, m7)
    one7 = k3.FusedCG(eng7.nx, eng7.ny, eng7.nz, eng7.taps,
                      coeffs=eng7.coeffs, planes=eng7.planes,
                      weight=eng7.weight, sym=eng7.sym)
    b7 = (B7.T * e7[None]).contiguous()
    r5 = eng7.solve(b7, tol=TOL, maxiter=n7)
    its5, its7 = int(r5.iterations[0]), res7.iterations.tolist()
    print(f"M6 DIA-7 192^3 through K5: {its5} iterations shared (K3 per "
          f"column {its7}), converged {r5.converged.tolist()}")
    check(bool(r5.converged.all()) and abs(its5 - max(its7)) <= 2,
          f"M6: K5 on DIA-7 took {its5} iterations vs K3's {its7}")
    versus_k3("DIA-7 192^3", eng7, one7, b7, its5, its7)
    del eng7, one7, b7, r5

    # PyTorch calls that compute K5 A's product (without its sums): the CSR
    # product of Ã at DIA-27 160^3 and conv3d with batch k at 224^3 (fp32,
    # cuDNN's TF32 off).
    d_label = "DIA-27 160^3"
    eng, e, _, p, q_ref = steps[d_label][:5]
    csr = scaled_csr(d160, e)
    pn = p.T.contiguous()
    check(maxrel(csr @ pn, q_ref.T) <= 1e-5,
          "the CSR product does not compute K5 A's product")
    t_csr = statistics.median(event_ms(lambda: csr @ pn, inner=10)
                              for _ in range(5))
    del csr
    s_label = "stencil 224^3"
    p224, q224 = steps[s_label][3], steps[s_label][4]
    torch.backends.cudnn.allow_tf32 = False
    wk = torch.zeros((1, 1, 3, 3, 3), device=dev)
    wk[0, 0, 1, 1, 1] = 6.0
    for tap in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                (1, 1, 2)):
        wk[(0, 0) + tap] = -1.0
    xv = p224.view(k, 1, *N224)

    def conv():
        return torch.nn.functional.conv3d(xv, wk, padding=1)

    check(maxrel(conv().reshape(k, -1), q224) <= 1e-6,
          "conv3d does not compute K5 A's product")
    conv()
    t_conv = statistics.median(event_ms(conv, inner=10) for _ in range(5))
    print(f"[{card}] M6 PyTorch calls of K5 A's product alone: CSR product "
          f"of Ã at {d_label} {t_csr * 1e3:.2f} us (K5 A one call "
          f"{per_call[d_label][0] * 1e3:.2f} us); conv3d batch {k} at "
          f"{s_label} {t_conv * 1e3:.2f} us (K5 A one call "
          f"{per_call[s_label][0] * 1e3:.2f} us)")

    t_a, t_ap, t_b, t_bp = per_call[d_label]
    ms_b = dev_ms.get(d_label, (t_a, t_b))[1]
    return [
        {"name": "fused_multi_a", "route": "cuda",
         "source": "cgx_torch/csrc/fused_multi.cu",
         "replaces": "cgx/kernels/fused_multi.py:64",
         "launches": launches["a"], "max_abs_err": errs["a"],
         "ms": first_a[d_label][0], "before_ms": first_a[d_label][1],
         "plain_ms": t_ap, "bound_ms": bounds[d_label][0][0],
         "bound_by": bounds[d_label][0][1], "library_ms": t_csr},
        {"name": "fused_multi_b", "route": "cuda",
         "source": "cgx_torch/csrc/fused_multi.cu",
         "replaces": "cgx/kernels/fused_multi.py:204",
         "launches": launches["b"], "max_abs_err": errs["b"], "ms": ms_b,
         "plain_ms": t_bp, "bound_ms": bounds[d_label][1][0],
         "bound_by": bounds[d_label][1][1], "library_ms": None},
    ]


def random_bell(nbr, seed, dev):
    """The records' block-dense operator: ``nbr`` block rows of BELL_WB
    distinct sorted block columns each (numpy, ``seed``), values standard
    normal fp32, as a BlockELL on ``dev`` and as the CSR-of-blocks arrays
    ``(crow, col, values)`` of the same matrix for torch's BSR product.
    (experiments/bell_pair_proto.py:65 drew columns with repeats; distinct
    columns make the same matrix a valid BSR.)"""
    from cgx_torch.kernels.bsr import BlockELL

    rng = np.random.default_rng(seed)
    cols = np.sort(np.stack([rng.choice(nbr, BELL_WB, replace=False)
                             for _ in range(nbr)]), axis=1).astype(np.int32)
    vals = torch.from_numpy(rng.standard_normal(
        (nbr, BELL_WB, BELL_BS, BELL_BS), dtype=np.float32)).to(dev)
    a = BlockELL(values=vals, block_cols=torch.from_numpy(cols).to(dev),
                 shape=(nbr * BELL_BS, nbr * BELL_BS))
    crow = torch.arange(0, nbr * BELL_WB + 1, BELL_WB, device=dev)
    return a, (crow, a.block_cols.reshape(-1).long(),
               vals.reshape(-1, BELL_BS, BELL_BS))


def product64(a, x) -> np.ndarray:
    """``A @ X`` of a BlockELL in numpy fp64, slot by slot."""
    vals = a.values.double().cpu().numpy()
    cols = a.block_cols.long().cpu().numpy()
    nbr, wb, bs, _ = vals.shape
    xb = x.double().cpu().numpy().reshape(-1, bs, x.shape[1])
    y = np.zeros((nbr, bs, x.shape[1]))
    for j in range(wb):
        y += np.matmul(vals[:, j], xb[cols[:, j]])
    return y.reshape(nbr * bs, -1)


def other_launches() -> dict:
    """The launch counters of every kernel but K11, by (module, name)."""
    from cgx_torch.kernels import fused_engine as k3
    from cgx_torch.kernels import fused_multi as k5
    from cgx_torch.kernels import fused_resident as k2
    from cgx_torch.kernels import stencil as k1
    from cgx_torch.kernels import wbell as kw

    names = ((k1, "stencil3d_spmv_launches"), (k2, "resident_cg_launches"),
             (k2, "resident_dia_launches"), (k3, "fused_a_launches"),
             (k3, "fused_b_launches"), (k5, "multi_a_launches"),
             (k5, "multi_b_launches"), (kw, "wbell_resident_launches"),
             (kw, "wbell_tiered_launches"), (kw, "wbell_windowed_launches"))
    return {(m, nm): getattr(m, nm) for m, nm in names}


def bsr_phases(dev, card):
    """B1–B5: the block-sparse path (K11, BSR/COO, the CSR builders, the
    legacy format).  Returns K11's entry of the report line and B1's and
    B2's operands ``{"B1": (a, x, bsr arrays), "B2": ...}`` (k = 256; B2 in
    bf16) for E4–E6."""
    import cgx_torch
    from cgx_torch.io.legacy import read_legacy, write_legacy
    from cgx_torch.io.poisson import poisson2d, poisson3d
    from cgx_torch.kernels import bsr as kb

    # The plain versions' fp32 matmuls must run in full fp32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on for fp32 matmuls")
    for (m, nm) in other_launches():
        setattr(m, nm, 0)
    for p in kb.PATHS:
        setattr(kb, f"bell_{p}_launches", 0)
    kb.bell_spmm_launches = 0
    phase_launches = {}

    def took(label, want, before):
        """Assert that K11's launches since ``before`` all took path
        ``want`` (by the path counters); return them by path."""
        now = kb.bell_path_launches()
        moved = {p: now[p] - before[p] for p in now if now[p] != before[p]}
        print(f"{label}: K11's launches by path {moved}")
        check(set(moved) == {want}, f"{label} took the paths {moved}, not "
              f"{want} alone")
        return moved

    def held(label, run, plain, y64=None):
        """Run K11 once (one launch), hold it to its plain version (and to
        an fp64 product), and once more for bitwise reproducibility."""
        before = kb.bell_spmm_launches
        y = run()
        torch.cuda.synchronize()
        check(kb.bell_spmm_launches == before + 1,
              f"{label}: the launch counter moved by "
              f"{kb.bell_spmm_launches - before}")
        y_ref = plain()
        scale = float(y_ref.abs().max())
        err = float((y - y_ref).abs().max())
        line = (f"{label}: max|y - plain| {err:.3e} (bound 1e-5 * "
                f"{scale:.3e})")
        check(y.dtype == torch.float32, f"{label}: output {y.dtype}")
        check(err <= 1e-5 * scale, f"{label} disagrees with its plain "
              f"version: {err}")
        if y64 is not None:
            e64 = float(np.abs(y.double().cpu().numpy() - y64).max())
            line += f", max|y - fp64| {e64:.3e}"
            check(e64 <= 1e-5 * float(np.abs(y64).max()),
                  f"{label} disagrees with the fp64 product: {e64}")
        same = torch.equal(run(), y)
        print(line + f", two runs bitwise equal: {same}")
        check(same, f"{label}: two runs differ")
        return y, err

    # -- B1. fp32, 512 block rows, k = 256 and 512 ---------------------------
    t0 = time.perf_counter()
    a1, bsr1 = random_bell(BELL_ROWS["B1"], SEED, dev)
    rng = np.random.default_rng(SEED + 10)
    xs1 = {k: torch.from_numpy(rng.standard_normal(
        (a1.shape[1], k), dtype=np.float32)).to(dev) for k in (256, 512)}
    print(f"B1 block-ELL {BELL_ROWS['B1']} block rows, bs {BELL_BS}, wb "
          f"{BELL_WB}: "
          f"{a1.values.numel()} stored values, built in "
          f"{time.perf_counter() - t0:.1f} s")
    errs, ys = {}, {}
    counts = kb.bell_path_launches()
    for k, x in xs1.items():
        y64 = product64(a1, x)
        for engine in ("auto", "dma"):
            ys["B1", k], errs["B1", k, engine] = held(
                f"B1 fp32 k={k} engine={engine}",
                lambda: kb.bell_spmm(a1, x, engine=engine),
                lambda: kb.bell_spmm_reference(a1, x), y64)
    phase_launches["B1"] = kb.bell_spmm_launches
    paths = {"B1": took("B1", "tiled", counts)}

    # -- B2. bf16 operands, 1024 block rows, k = 256 -------------------------
    a2, bsr2 = random_bell(BELL_ROWS["B2"], SEED + 1, dev)
    x2 = torch.from_numpy(np.random.default_rng(SEED + 11).standard_normal(
        (a2.shape[1], 256), dtype=np.float32)).to(dev)
    a2h, x2h = a2.astype(torch.bfloat16), x2.to(torch.bfloat16)
    counts = kb.bell_path_launches()
    y2, errs["B2"] = held("B2 bf16 k=256", lambda: kb.bell_spmm(a2h, x2h),
                          lambda: kb.bell_spmm_reference(a2h, x2h))
    paths["B2"] = took("B2", "mma", counts)
    y2_32 = kb.bell_spmm_reference(a2, x2)
    rel2 = float(torch.linalg.vector_norm(y2 - y2_32)
                 / torch.linalg.vector_norm(y2_32))
    print(f"B2 bf16: {a2h.values.numel()} stored values, output "
          f"{y2.dtype}; |y - y_fp32| / |y_fp32| {rel2:.3e} (bound 3e-2)")
    check(rel2 <= 3e-2, f"B2: bf16 product {rel2} from the fp32 one")
    del y2, y2_32
    phase_launches["B2"] = kb.bell_spmm_launches - phase_launches["B1"]

    # -- B3. poisson3d(128, 128, 128) through BSR (bs 8) and block-ELL ------
    t0 = time.perf_counter()
    a3c = poisson3d(*N128, dtype=np.float32, device=dev)
    t_csr = time.perf_counter() - t0
    t0 = time.perf_counter()
    b3 = cgx_torch.bsr_from_csr(a3c, 8)
    a3 = kb.bell_from_bsr(b3)
    torch.cuda.synchronize()
    n_pad = a3.values.shape[0] * a3.wb - b3.nnzb
    print(f"B3 poisson3d 128^3: {a3c.shape[0]} rows, {a3c.nnz} nnz (CSR "
          f"built in {t_csr:.1f} s); BSR bs 8 and block-ELL in "
          f"{time.perf_counter() - t0:.1f} s: {b3.nnzb} blocks, wb "
          f"{a3.wb}, {n_pad} padding blocks")
    x3 = torch.from_numpy(np.random.default_rng(SEED + 12).standard_normal(
        (a3c.shape[0], 4), dtype=np.float32)).to(dev)
    x31 = x3[:, 0].contiguous()
    counts = kb.bell_path_launches()
    ys["B3", 1], _ = held("B3 bell_spmv k=1", lambda: kb.bell_spmv(a3, x31),
                          lambda: cgx_torch.spmv(a3c, x31))
    ys["B3", 4], _ = held("B3 bell_spmm k=4", lambda: kb.bell_spmm(a3, x3),
                          lambda: cgx_torch.spmm(a3c, x3))
    paths["B3"] = took("B3", "rows", counts)
    phase_launches["B3"] = (kb.bell_spmm_launches - phase_launches["B1"]
                            - phase_launches["B2"])
    k11_launches = kb.bell_spmm_launches
    k11_paths = kb.bell_path_launches()

    # -- B4. the path as a user drives it: BSR/COO solves, the legacy file ---
    a4c = poisson3d(*N64, dtype=np.float32, device=dev)
    n4 = a4c.shape[0]
    b4 = torch.from_numpy(np.random.default_rng(SEED + 13).standard_normal(
        n4).astype(np.float32)).to(dev)
    its_csr = int(cgx_torch.auto_solve(a4c, b4, tol=TOL).iterations)
    x64 = cgx_torch.cg_solve(a4c.astype(torch.float64), b4.double(),
                             tol=1e-10, maxiter=20000).x
    bsr4 = cgx_torch.bsr_from_csr(a4c, 8)
    for label, op in (("BSR", bsr4), ("COO", a4c.to_coo())):
        route = cgx_torch.select_backend(op, b4)
        check(route == "xla", f"B4 {label} routed to {route}")
        t0 = time.perf_counter()
        res = cgx_torch.auto_solve(op, b4, tol=TOL)
        torch.cuda.synchronize()
        its = int(res.iterations)
        fwd = rel(res.x, x64)
        print(f"B4 auto_solve over {label} 64^3 (route {route}): {its} "
              f"iterations (CSR {its_csr}), converged "
              f"{bool(res.converged)}, |x-x64|/|x64| {fwd:.3e}, "
              f"{time.perf_counter() - t0:.2f} s (host clock)")
        check(bool(res.converged), f"B4 {label} did not converge")
        check(abs(its - its_csr) <= 0.02 * its_csr,
              f"B4 {label}: {its} vs CSR {its_csr} iterations")
        check(fwd <= 1e-4, f"B4 {label}: forward error {fwd}")
    B4 = seeded_block(n4, K_MULTI, SEED + 14, dev)
    multi = cgx_torch.cg_solve_multi(bsr4, B4, tol=TOL)
    for j in range(K_MULTI):
        one = cgx_torch.cg_solve(bsr4, B4[:, j].contiguous(), tol=TOL)
        its_m, its1 = int(multi.iterations[j]), int(one.iterations)
        dxj = rel(multi.x[:, j], one.x)
        print(f"B4 cg_solve_multi over BSR, column {j}: {its_m} iterations "
              f"(single {its1}), |dx|/|x| {dxj:.3e}")
        check(bool(multi.converged[j]) and abs(its_m - its1) <= max(
            2, 0.02 * its1) and dxj <= 1e-4, f"B4 column {j} differs")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "legacy_poisson2d_256.txt")
    a5 = poisson2d(*LEGACY_2D, device=dev)
    b5 = torch.from_numpy(np.random.default_rng(SEED + 15).standard_normal(
        a5.shape[0])).to(dev)
    write_legacy(path, a5, b5)
    ra, rb = read_legacy(path, device=dev)
    same = all(torch.equal(getattr(ra, f), getattr(a5, f))
               for f in ("values", "col_indices", "indptr")) \
        and torch.equal(rb, b5)
    rc, rcb = read_legacy(path, device="cpu")
    xg = cgx_torch.cg_solve(ra, rb, tol=0.0, maxiter=50).x
    xc = cgx_torch.cg_solve(rc, rcb, tol=0.0, maxiter=50).x
    dleg = rel(xg.cpu(), xc)
    print(f"B4 legacy 4-line file of poisson2d(256, 256) "
          f"({os.path.getsize(path)} bytes): read back equal: {same}; "
          f"cg_solve(tol=0, maxiter=50) fp64 on the card vs the CPU: "
          f"|dx|/|x| {dleg:.3e} (bound 1e-12)")
    check(same, "B4: the legacy file did not read back equal")
    check(dleg <= 1e-12, f"B4: the legacy solve differs by {dleg}")
    others = {nm: v for (_, nm), v in other_launches().items() if v}
    print(f"B1-B4 launches: K11 {k11_launches} (B1 {phase_launches['B1']}, "
          f"B2 {phase_launches['B2']}, B3 {phase_launches['B3']}, B4 "
          f"{kb.bell_spmm_launches - k11_launches}); other kernels "
          f"{others or 'none'}")
    check(min(phase_launches.values()) > 0, f"K11 did not run in every "
          f"phase: {phase_launches}")
    check(kb.bell_spmm_launches == k11_launches and not others,
          "B4 launched a kernel")

    # -- B1 and B3 against the general path (the first kernel), bit for bit -
    # (after the counts: these launches are the yardstick's, not the path's)
    for (phase, k), a, x in ((("B1", 256), a1, xs1[256]),
                             (("B1", 512), a1, xs1[512]),
                             (("B3", 1), a3, x31[:, None]),
                             (("B3", 4), a3, x3)):
        gp = kb.bell_plan(a.blocksize, k, x.dtype, True, path="general")
        yg = kb._k11(a, x, gp)
        same = torch.equal(yg.reshape(ys[phase, k].shape), ys[phase, k])
        path = kb.bell_plan(a.blocksize, k, x.dtype, True).path
        print(f"{phase} k={k}: the {path} "
              f"path equal to the general path bit for bit: {same}")
        check(same, f"{phase} k={k} differs from the general path")

    # -- B5. times -------------------------------------------------------------
    from cgx_torch.experiments import interleaved_ms

    def library(label, bsr_arrays, size, x, ref):
        """torch's BSR tensor of the same matrix, checked to compute K11's
        function, or None where its product raises for the dtype."""
        crow, col, vals = bsr_arrays
        try:
            m = torch.sparse_bsr_tensor(crow, col, vals, size=size,
                                        check_invariants=False)
            y = m @ x
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, ValueError) as exc:
            print(f"B5 {label}: torch's BSR product raised "
                  f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}")
            return None
        dev_ = maxrel(y.float(), ref)
        print(f"B5 {label}: torch's BSR product within {dev_:.3e} of the "
              f"plain version")
        check(dev_ <= (1e-5 if x.dtype == torch.float32 else 2e-2),
              f"B5 {label}: torch's BSR product does not compute K11's "
              f"function")
        return m

    def work(nblocks, bs, k, elem, nbc, nbr, peak):
        """Each input read once (the real blocks, their column ids, X), Y
        written once in fp32; 2 bs² k operations per real block."""
        nbytes = (nblocks * (bs * bs * elem + 4) + nbc * bs * k * elem
                  + nbr * bs * k * 4)
        return bound(nbytes, 2.0 * nblocks * bs * bs * k, peak)

    b3_arrays = (b3.indptr, b3.col_indices, b3.values)
    timed = {
        "B1 fp32 k=256": (a1, xs1[256], bsr1, FP32_FLOPS),
        "B1 fp32 k=512": (a1, xs1[512], bsr1, FP32_FLOPS),
        "B2 bf16 k=256": (a2h, x2h, (bsr2[0], bsr2[1],
                                     bsr2[2].to(torch.bfloat16)),
                          BF16_TC_FLOPS),
        "B3 poisson3d 128^3 k=1": (a3, x3[:, :1].contiguous(), b3_arrays,
                                   FP32_FLOPS),
        "B3 poisson3d 128^3 k=4": (a3, x3, b3_arrays, FP32_FLOPS),
    }
    csr3 = torch.sparse_csr_tensor(a3c.indptr, a3c.col_indices, a3c.values,
                                   size=a3c.shape, check_invariants=False)
    times = {}
    for label, (a, x, arrays, peak) in timed.items():
        nbr, _, bs, _ = a.values.shape
        k = x.shape[1]
        plan = kb.bell_plan(bs, k, x.dtype, True)
        general = kb.bell_plan(bs, k, x.dtype, True, path="general")
        m = library(label, arrays, a.shape, x, kb.bell_spmm_reference(a, x))
        # Interleaved: the path, the general path (the first design: the
        # same-run "before"), the plain version, torch's product(s).
        fns = {"K11": lambda: kb.bell_spmm(a, x),
               "general": lambda: kb._k11(a, x, general),
               "plain": lambda: kb.bell_spmm_reference(a, x)}
        if m is not None:
            fns["BSR"] = lambda: m @ x
        if label.startswith("B3"):
            fns["CSR"] = lambda: csr3 @ x
        ms = interleaved_ms(fns, reps=5, inner=5)
        nblocks = b3.nnzb if label.startswith("B3") else nbr * a.wb
        b_ms, b_by = work(nblocks, bs, k, x.element_size(),
                          a.shape[1] // bs, nbr, peak)
        flops = 2.0 * nblocks * bs * bs * k
        t_k, lib = ms["K11"], ms.get("BSR")
        times[label] = (t_k, ms["plain"], b_ms, b_by, lib)
        print(f"[{card}] B5 {label}: K11 ({plan.path} path) "
              f"{t_k * 1e3:.1f} us ({flops / (t_k * 1e-3) / 1e12:.2f} "
              f"TFLOP/s, {b_ms / t_k:.1%} of the bound); general path "
              f"{ms['general'] * 1e3:.1f} us ({b_ms / ms['general']:.1%}); "
              f"bound {b_ms * 1e3:.1f} us ({b_by}); plain "
              f"{ms['plain'] * 1e3:.1f} us; torch BSR product "
              + (f"{lib * 1e3:.1f} us" if lib is not None else "n/a")
              + "".join(f"; {nm} {ms[nm] * 1e3:.1f} us"
                        for nm in ("CSR",) if nm in ms))
        check(t_k < ms["general"], f"B5 {label}: the {plan.path} path is "
              f"not faster than the general path")
        if lib is not None and not label.startswith("B3"):
            check(t_k < lib, f"B5 {label}: K11 is not faster than torch's "
                  f"BSR product")

    # The plan's edge for small blocks, on B3's operator with a block of
    # right-hand sides: at k = 32 a tiled block would have 4 threads and the
    # plan takes the general path, at k = 64 it has 8 and the plan tiles.
    for k in (32, 64):
        x = torch.from_numpy(np.random.default_rng(SEED + 16 + k)
                             .standard_normal((a3.shape[1], k),
                                              dtype=np.float32)).to(dev)
        plan = kb.bell_plan(8, k, x.dtype, True)
        other = kb.bell_plan(8, k, x.dtype, True, path="tiled"
                             if plan.path == "general" else "general")
        ms = interleaved_ms({"plan": lambda: kb._k11(a3, x, plan),
                             "other": lambda: kb._k11(a3, x, other)},
                            reps=5, inner=5)
        same = torch.equal(kb._k11(a3, x, plan), kb._k11(a3, x, other))
        print(f"[{card}] B5 B3 poisson3d 128^3 k={k}: the plan's "
              f"{plan.path} path {ms['plan'] * 1e3:.1f} us, the "
              f"{other.path} path {ms['other'] * 1e3:.1f} us "
              f"({other.threads} threads a block); equal bit for bit: "
              f"{same}")
        check(same and ms["plan"] < ms["other"], f"B5 B3 k={k}: the plan's "
              f"{plan.path} path is not the faster, or differs")
        del x

    t_k, t_p, b_ms, b_by, lib = times["B1 fp32 k=256"]
    bells = {"B1": timed["B1 fp32 k=256"][:3],
             "B2": timed["B2 bf16 k=256"][:3]}
    return [{"name": "bell_spmm", "route": "cuda",
             "source": "cgx_torch/csrc/bsr.cu",
             "replaces": "cgx/kernels/bsr.py:93,151",
             "path": kb.bell_plan(BELL_BS, 256, torch.float32, True).path,
             "paths": k11_paths,
             "launches": k11_launches,
             "max_abs_err": errs["B1", 256, "auto"], "ms": t_k,
             "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": lib}], bells


def proto_phases(dev, card, thermal, bells):
    """E1–E6: K10, P1 and P3 on W1's thermal2 stand-in; K12 and P2 on B1's
    and B2's block-ELL operators.  Returns their entries of the report
    line."""
    from cgx_torch.experiments import bell_pair_proto as p2
    from cgx_torch.experiments import halfblock_proto as p3
    from cgx_torch.experiments import interleaved_ms
    from cgx_torch.experiments import tier_proto as p1
    from cgx_torch.kernels import bsr as kb
    from cgx_torch.kernels import wbell as kw

    a, op, plan = thermal
    n, nt = a.shape[0], op.nt
    rng = np.random.default_rng(SEED + 20)
    xs4 = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32)
                           ).to(dev)
    xb = torch.stack([op.to_internal(xs4[:, c]) for c in range(4)])
    xst = kw.to_stacked(xb)
    a64 = torch.sparse_csr_tensor(a.indptr, a.col_indices, a.values.double(),
                                  size=a.shape, check_invariants=False)

    # The prototypes' host builds and their row layouts, built on the card
    # (set-up, before the path).
    t0 = time.perf_counter()
    tv, tl, tpg, steps = p1.build_tiers(op, 8)
    twalk = p1.tier_walk(tpg, tv, nt)
    torch.cuda.synchronize()
    t_tiers = time.perf_counter() - t0
    t0 = time.perf_counter()
    trows = p1.tier_rows(tpg, tl, tv, nt, twalk)
    torch.cuda.synchronize()
    t_trows = time.perf_counter() - t0
    t0 = time.perf_counter()
    hv, hlc, hog, hga, hfill, hreal = p3.build_halfblock(a, 16, device=dev)
    hpk = (hog << 16) | hga
    hwalk = p3.half_walk(hpk, hlc, hv, nt, 16)
    torch.cuda.synchronize()
    t_half = time.perf_counter() - t0
    t0 = time.perf_counter()
    hrows = p3.half_rows(hpk, hlc, hv, nt, hwalk)
    torch.cuda.synchronize()
    t_hrows = time.perf_counter() - t0
    kept7 = int(op.resident_walk[0].numel())
    kept1, kept3 = int(twalk[0].numel()), int(hwalk[0].numel())
    print(f"E2 build_tiers on thermal2: {t_tiers:.2f} s (host), steps "
          f"{steps} x 8, {kept1} non-zero planes (K8's plan {plan.steps})")
    print(f"E3 build_halfblock on thermal2 (span 16): {t_half:.2f} s (host), "
          f"fill {hfill:.2f}x, {hreal} planes ({kept3} non-zero); the 8x8 "
          f"build: fill {op.nnz_stored / a.nnz:.2f}x, {kept7} non-zero "
          f"planes")
    for label, rows, t_rows in (("E2 P1", trows, t_trows),
                                ("E3 P3", hrows, t_hrows)):
        print(f"{label} row layout: built from the planes on the card in "
              f"{t_rows:.3f} s; {rows.slots} slots for {rows.nnz} nonzeros "
              f"(padding {rows.slots / rows.nnz:.3f}x), "
              f"{rows.nbytes / 1e6:.1f} MB (K7's {op.rows.nbytes / 1e6:.1f}),"
              f" {16 if rows.cols.dtype == torch.int16 else 32}-bit columns"
              f"{', segmented' if rows.segmented else ''}, widest window "
              f"{rows.window} floats")
        check(rows.nnz == a.nnz, f"{label}'s row layout holds {rows.nnz} of "
              f"{a.nnz} nonzeros")
    a1, x1, _ = bells["B1"]
    a2, x2, _ = bells["B2"]
    a3, _ = random_bell(300, SEED + 3, dev)
    x3 = torch.from_numpy(np.random.default_rng(SEED + 21).standard_normal(
        (a3.shape[1], 256), dtype=np.float32)).to(dev)

    def tier(x):
        return p1.tier_spmm(tpg, tl, tv, x, steps=steps, splane=8,
                            rows=trows)

    def tier_walk_plain(x):
        return p1.tier_spmm_reference(tpg, tl, tv, x, steps=steps, splane=8,
                                      walk=twalk)

    def half(x):
        return p3.half_spmv(hpk, hlc, hv, x, span=16, splane=64, rows=hrows)

    def half_walk_plain(x):
        return p3.half_reference(hpk, hlc, hv, x, span=16, splane=64,
                                 walk=hwalk)

    # P1's and P3's plain versions (their layouts'), and the plane-walking
    # kernels they replace (the same-run "before", counted nowhere).
    protos = {
        "P1": (tier, lambda x: kw.rows_product(trows, x), tier_walk_plain,
               lambda x: p1._planes_p1(tpg, tl, tv, x, twalk)),
        "P3": (half, lambda x: kw.rows_product(hrows, x), half_walk_plain,
               lambda x: p3._planes_p3(hpk, hlc, hv, x, hwalk))}

    def hold_proto(name, label, x):
        """Run prototype ``name`` twice on ``x`` and hold it bit for bit
        against its plain version, its plane walk's plain version and the
        plane-walking kernel; returns y and max|y - plain|."""
        run, plain, walk_plain, planes = protos[name]
        y = run(x)
        again = run(x)
        torch.cuda.synchronize()
        y_ref, y_walk, y_planes = plain(x), walk_plain(x), planes(x)
        torch.cuda.synchronize()
        print(f"{label}: equal bit for bit to its plain version: "
              f"{torch.equal(y, y_ref)}, to the plane walk's plain version: "
              f"{torch.equal(y, y_walk)}, to the plane walk it replaces: "
              f"{torch.equal(y, y_planes)}; two runs equal: "
              f"{torch.equal(y, again)}")
        check(torch.equal(y, y_ref), f"{label} differs from its plain version")
        check(torch.equal(y, y_walk), f"{label} differs from its plane walk's "
              "plain version")
        check(torch.equal(y, y_planes), f"{label} differs from the plane walk")
        check(torch.equal(y, again), f"{label}: two runs differ")
        return y, float((y - y_ref).abs().max())

    def paired(a_, x_):
        return p2.bell_spmm_paired(a_.block_cols, a_.values,
                                   x_.reshape(-1, BELL_BS, x_.shape[1]),
                                   k=x_.shape[1]).reshape(-1, x_.shape[1])

    def paired_plain(a_, x_):
        return p2.bell_pair_reference(a_.block_cols, a_.values,
                                      x_.reshape(-1, BELL_BS, x_.shape[1]),
                                      k=x_.shape[1]).reshape(-1, x_.shape[1])

    counters = ((kw, "wbell_stacked_launches"), (p1, "tier_spmm_launches"),
                (p3, "half_spmv_launches"), (kb, "bell_prefetch_launches"),
                (p2, "bell_pair_launches"))
    for m, nm in counters:
        setattr(m, nm, 0)
    errs = {}

    # -- E1. K10: the stacked layout, k = 4 -----------------------------------
    y10 = kw.wbell_spmm_stacked(op, xst)
    again = kw.wbell_spmm_stacked(op, xst)
    y7 = kw.wbell_spmm(op, xb)
    torch.cuda.synchronize()
    y10_ref = kw.wbell_stacked_reference(op, xst)
    y10_first = kw._planes_k10(op, xst)
    torch.cuda.synchronize()
    errs["K10"] = float((y10 - y10_ref).abs().max())
    same7 = torch.equal(kw.from_stacked(y10), y7)
    print(f"E1 K10 thermal2 k=4 (K7's row layout): from_stacked(K10) equal "
          f"to K7 bit for bit: {same7}; equal to its plain version: "
          f"{torch.equal(y10, y10_ref)}; to its first design (the plane "
          f"walk): {torch.equal(y10, y10_first)}; two runs equal: "
          f"{torch.equal(y10, again)}")
    check(same7, "E1: K10 differs from K7")
    check(torch.equal(y10, y10_ref), "E1: K10 differs from its plain version")
    check(torch.equal(y10, y10_first), "E1: K10 differs from its first "
          "design")
    check(torch.equal(y10, again), "E1: two K10 runs differ")
    del y10_first

    # -- E2. P1: the tiered single call, k = 1 and 4 --------------------------
    errs["P1"] = 0.0
    for k in (1, 4):
        y, err = hold_proto("P1", f"E2 P1 thermal2 k={k}",
                            xb[:k].contiguous())
        errs["P1"] = max(errs["P1"], err)
        e7 = maxrel(y, y7[:k])
        print(f"E2 P1 thermal2 k={k}: max|y - K7| / max|K7| {e7:.3e} (bound "
              f"1e-5)")
        check(e7 <= 1e-5, f"E2 k={k}: P1 is {e7} from K7")

    # -- E3. P3: the 4x8 half-blocks, k = 1 -----------------------------------
    y, errs["P3"] = hold_proto("P3", "E3 P3 thermal2 k=1",
                               xb[:1].contiguous())
    y64 = (a64 @ xs4[:, :1].double())[:, 0]
    e64 = maxrel(op.from_internal(y[0]), y64)
    print(f"E3 P3 thermal2: vs the fp64 CSR product through the "
          f"permutation, max rel-to-peak {e64:.3e} (bound 1e-5)")
    check(e64 <= 1e-5, f"E3: P3 is {e64} from the fp64 product")

    # -- E4. K12: the chunked engine; E5. P2: paired slots --------------------
    k12 = {}
    for label, a_, x_ in (("B1 fp32", a1, x1), ("B2 bf16", a2, x2),
                          ("300 block rows fp32", a3, x3)):
        before = kb.bell_prefetch_launches
        y = kb.bell_spmm(a_, x_, engine="prefetch")
        torch.cuda.synchronize()
        chunks = kb.bell_prefetch_launches - before
        y11 = kb.bell_spmm(a_, x_)
        y_ref = kb.bell_prefetch_reference(a_, x_)
        y64 = product64(a_, x_)
        e64 = float(np.abs(y.double().cpu().numpy() - y64).max())
        k12[label] = float((y - y_ref).abs().max())
        want = -(-a_.values.shape[0] // kb.PREFETCH_ROWS)
        path = kb.bell_plan(a_.blocksize, x_.shape[1], x_.dtype, True).path
        print(f"E4 K12 {label} k={x_.shape[1]} ({path} path): {chunks} "
              f"chunk launches; "
              f"equal to K11 bit for bit: {torch.equal(y, y11)}; max|y - "
              f"plain| {k12[label]:.3e}; max|y - fp64| {e64:.3e} (bound "
              f"1e-5 * {np.abs(y64).max():.3e})")
        check(chunks == want, f"E4 {label}: {chunks} launches for {want} "
              "chunks")
        check(torch.equal(y, y11), f"E4 {label}: K12 differs from K11")
        check(e64 <= 1e-5 * float(np.abs(y64).max()),
              f"E4 {label}: K12 is {e64} from the fp64 product")
        if label == "300 block rows fp32":
            continue
        y2 = paired(a_, x_)
        torch.cuda.synchronize()
        y2_ref = paired_plain(a_, x_)
        errs["P2", label] = float((y2 - y2_ref).abs().max())
        print(f"E5 P2 {label} ({path} path): equal to K11 bit for bit: "
              f"{torch.equal(y2, y11)}; max|y - plain| "
              f"{errs['P2', label]:.3e} (bound 1e-5 * "
              f"{float(y2_ref.abs().max()):.3e})")
        check(torch.equal(y2, y11), f"E5 {label}: P2 differs from K11")
        check(errs["P2", label] <= 1e-5 * float(y2_ref.abs().max()),
              f"E5 {label}: P2 disagrees with its plain version")
    errs["K12"] = k12["B1 fp32"]
    try:
        p2.bell_spmm_paired(a1.block_cols[:, :7], a1.values[:, :7],
                            x1.reshape(-1, BELL_BS, 256), k=256)
        odd = False
    except ValueError:
        odd = True
    print(f"E5 P2 with wb 7 raises ValueError: {odd}")
    check(odd, "E5: an odd wb did not raise")
    launches = {nm: getattr(m, nm) for m, nm in counters}
    print(f"E1-E5 launches: {launches}")
    check(launches == {"wbell_stacked_launches": 2, "tier_spmm_launches": 4,
                       "half_spmv_launches": 2, "bell_prefetch_launches": 8,
                       "bell_pair_launches": 2},
          f"E1-E5 did not launch each kernel as driven: {launches}")

    # -- E6. times ------------------------------------------------------------
    a32 = torch.sparse_csr_tensor(a.indptr, a.col_indices, a.values.float(),
                                  size=a.shape, check_invariants=False)
    x1c = xs4[:, :1].contiguous()
    xk = {1: xb[:1].contiguous(), 4: xb}
    csr = {1: lambda: a32 @ x1c, 4: lambda: a32 @ xs4}
    w4 = interleaved_ms({
        "K7": lambda: kw.wbell_spmm(op, xb),
        "K8": lambda: kw.wbell_spmm_tiered(plan, xb),
        "K10": lambda: kw.wbell_spmm_stacked(op, xst),
        "P1": lambda: tier(xb),
        "P1 planes": lambda: protos["P1"][3](xb),
        "CSR": csr[4]})
    w1 = interleaved_ms({
        "K7": lambda: kw.wbell_spmm(op, xk[1]),
        "P1": lambda: tier(xk[1]),
        "P1 planes": lambda: protos["P1"][3](xk[1]),
        "P3": lambda: half(xk[1]),
        "P3 planes": lambda: protos["P3"][3](xk[1]),
        "CSR": csr[1]})
    wp = interleaved_ms({
        "K10": lambda: kw.wbell_stacked_reference(op, xst),
        "P1 k=4": lambda: protos["P1"][1](xb),
        "P1 k=1": lambda: protos["P1"][1](xk[1]),
        "P3": lambda: protos["P3"][1](xk[1])}, reps=3, inner=1)
    for k, ms in ((4, w4), (1, w1)):
        print(f"[{card}] E6 thermal2 k={k} (us/call): "
              + ", ".join(f"{nm} {t * 1e3:.1f}" for nm, t in ms.items())
              + f"; per RHS K7 {ms['K7'] * 1e3 / k:.1f}"
              + (f", K10 {ms['K10'] * 1e3 / k:.1f}" if k == 4 else ""))
    print(f"[{card}] E6 plain versions (us/call): "
          + ", ".join(f"{nm} {t * 1e3:.1f}" for nm, t in wp.items()))
    # K10 beside its first design (the plane walk) and K7, device time
    # (queued events), in turns.
    d10 = dict(zip(("K10", "K10 first", "K7"), in_turns([
        lambda: kw.wbell_spmm_stacked(op, xst),
        lambda: kw._planes_k10(op, xst),
        lambda: kw.wbell_spmm(op, xb)])))
    print(f"[{card}] E6 K10 thermal2 k=4, device (in turns): "
          f"{d10['K10'] * 1e3:.1f} us over K7's row layout; its first "
          f"design (the plane walk) {d10['K10 first'] * 1e3:.1f} us "
          f"({d10['K10'] / d10['K10 first']:.3f}x); K7 "
          f"{d10['K7'] * 1e3:.1f} us ({d10['K10'] / d10['K7']:.3f}x)")
    # Device time alone (queued events; the plain version's and a
    # cross-check of the kernel's by the profiler): P1 and P3, the plane
    # walks they replace, torch's CSR product, beside the one bound.
    plane_words = {"P1": (8192 + 128, kept1), "P3": (4096 + 128, kept3)}
    rows_of = {"P1": trows, "P3": hrows}
    dms = {}
    for label, k in (("P1", 1), ("P1", 4), ("P3", 1)):
        run, plain, _, planes = protos[label]
        x = xk[k]
        d_k, d_b, d_c = (queued_ms(f) for f in (
            lambda: run(x), lambda: planes(x), csr[k]))
        d_p, d_prof = device_ms(lambda: plain(x)), device_ms(lambda: run(x))
        dms[label, k] = (d_k, d_p, d_c)
        ev = (w1 if k == 1 else w4)
        io = wbell_io_bytes(op, k)
        least = wbell_least_bytes(a, op, k)
        own = rows_of[label].call_bytes(k)
        words, kept = plane_words[label]
        walk_bytes = kept * (words * 4 + 8) + io
        print(f"[{card}] E6 {label} k={k}: {ev[label] * 1e3:.1f} us (events),"
              f" device {d_k * 1e3:.1f} us (the profiler's "
              f"{d_prof * 1e3:.1f}); the plane walk it replaces "
              f"{ev[label + ' planes'] * 1e3:.1f} us, device "
              f"{d_b * 1e3:.1f}; torch CSR product {ev['CSR'] * 1e3:.1f} us, "
              f"device {d_c * 1e3:.1f}; plain device {d_p * 1e3:.1f} us; "
              f"bound {us_of(least):.1f} us ({least / 1e6:.1f} MB, the "
              f"fewest bytes that move Y = A·X); its own layout "
              f"{us_of(own):.1f} us ({own / 1e6:.1f} MB), the planes' "
              f"{us_of(walk_bytes):.1f} us ({walk_bytes / 1e6:.1f} MB)")
        if k == 1:
            check(d_k < d_c, f"E6 {label} k=1: device time {d_k * 1e3:.1f} "
                  f"us is not below the CSR product's ({d_c * 1e3:.1f} us)")

    def bsr_ms(arrays, size, x):
        """ms of torch's BSR product of the same matrix, or None where it
        raises for the dtype (as in B5)."""
        crow, col, vals = arrays
        m = torch.sparse_bsr_tensor(crow, col, vals.to(x.dtype), size=size,
                                    check_invariants=False)
        try:
            return interleaved_ms({"BSR": lambda: m @ x}, inner=5)["BSR"]
        except (RuntimeError, NotImplementedError) as exc:
            print(f"E6: torch's BSR product raised {type(exc).__name__}")
            return None

    bt = {}
    for label in ("B1", "B2"):
        a_, x_, arrays = bells[label]
        bt[label] = interleaved_ms({
            "K11": lambda: kb.bell_spmm(a_, x_),
            "K12": lambda: kb.bell_spmm(a_, x_, engine="prefetch"),
            "P2": lambda: paired(a_, x_)}, inner=5)
        bt[label].update(interleaved_ms({
            "K12 plain": lambda: kb.bell_prefetch_reference(a_, x_),
            "P2 plain": lambda: paired_plain(a_, x_)}, reps=3, inner=2))
        bt[label]["BSR"] = bsr_ms(arrays, a_.shape, x_)
        print(f"[{card}] E6 {label} k=256 (us/call): "
              + ", ".join(f"{nm} {t * 1e3:.1f}" if t is not None
                          else f"{nm} n/a" for nm, t in bt[label].items()))

    nbr1 = a1.values.shape[0]
    b1 = bound(nbr1 * BELL_WB * (BELL_BS * BELL_BS * 4 + 4)
               + a1.shape[1] * 256 * 4 + nbr1 * BELL_BS * 256 * 4,
               2.0 * nbr1 * BELL_WB * BELL_BS * BELL_BS * 256)
    b4, b3 = wbell_bound(a, op, 4), wbell_bound(a, op, 1)
    for label, b in (("K10, P1 k=4", b4), ("P1, P3 k=1", b3),
                     ("K12/P2 B1", b1)):
        print(f"[{card}] E6 bound {label}: {b[0] * 1e3:.1f} us ({b[1]})")

    def entry(name, source, replaces, key, err, ms, plain_ms, b, lib,
              device=None):
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches[key],
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b[0], "bound_by": b[1], "library_ms": lib}
        if device is not None:
            e.update(zip(("device_ms", "device_plain_ms",
                          "device_library_ms"), device))
        return e

    wsrc, bsrc = "cgx_torch/csrc/wbell.cu", "cgx_torch/csrc/bsr.cu"
    return [
        dict(entry("wbell_spmm_stacked", wsrc, "cgx/kernels/wbell.py:384",
                   "wbell_stacked_launches", errs["K10"], w4["K10"],
                   wp["K10"], b4, w4["CSR"]), device_ms=d10["K10"],
             before_device_ms=d10["K10 first"], k7_device_ms=d10["K7"]),
        entry("bell_spmm_prefetch", bsrc, "cgx/kernels/bsr.py:215",
              "bell_prefetch_launches", errs["K12"], bt["B1"]["K12"],
              bt["B1"]["K12 plain"], b1, bt["B1"]["BSR"]),
        entry("tier_spmm", wsrc, "experiments/tier_proto.py:53",
              "tier_spmm_launches", errs["P1"], w4["P1"], wp["P1 k=4"], b4,
              w4["CSR"], dms["P1", 4]),
        entry("bell_spmm_paired", bsrc, "experiments/bell_pair_proto.py:16",
              "bell_pair_launches", errs["P2", "B1 fp32"], bt["B1"]["P2"],
              bt["B1"]["P2 plain"], b1, bt["B1"]["BSR"]),
        entry("half_spmv", wsrc, "experiments/halfblock_proto.py:93",
              "half_spmv_launches", errs["P3"], w1["P3"], wp["P3"], b3,
              w1["CSR"], dms["P3", 1]),
    ]


def seeded_rhs(n, dev):
    """The seeded right-hand side of the DIA phases: standard normal from
    SEED, fp32."""
    return torch.from_numpy(np.random.default_rng(SEED).standard_normal(n)
                            .astype(np.float32)).to(dev)


def device_us(prof, pick):
    """(µs of device time, launches) of the kernels whose profiler key
    satisfies ``pick``."""
    evs = [ev for ev in prof.key_averages()
           if ev.self_device_time_total > 0 and pick(ev.key)]
    return (sum(ev.self_device_time_total for ev in evs),
            sum(ev.count for ev in evs))


def mixed_phases(dev, card, dias, fp64_solution, relres_of):
    """X1–X5: mixed precision.  ``auto_solve(..., mixed_precision=True)``
    (``ir_cg_solve`` over K3's narrow modes), K2's and K5's bf16 planes,
    and their times.  ``dias`` holds DIA-7 192³, DIA-27 128³ and DIA-27
    160³; ``fp64_solution(label, rhs name, a, b)`` and ``relres_of(a, b,
    x)`` are the main phases' fp64 yardsticks.  Returns the report line's
    entries of the narrow modes."""
    import cgx_torch
    from cgx_torch.kernels import fused_dia_cg as fdia
    from cgx_torch.kernels import fused_engine as k3
    from cgx_torch.kernels import fused_multi as k5
    from cgx_torch.kernels import fused_resident as k2
    from cgx_torch.kernels.fused_cg import build_fused
    from cgx_torch.solve.auto import BF16_PLANE_MIN_SPEEDUP
    from cgx_torch.solve.ir import ir_cg_solve_reference
    from torch.profiler import ProfilerActivity, profile

    bf16 = torch.bfloat16

    def zero():
        k3.fused_a_launches = k3.fused_b_launches = 0
        k3.fused_a_bf16_launches = k3.fused_b_bf16_launches = 0
        k3.fused_a_bf16_planes_launches = 0
        k2.resident_cg_launches = k2.resident_dia_launches = 0
        k2.resident_dia_bf16_launches = 0
        k5.multi_a_launches = k5.multi_b_launches = 0
        k5.multi_a_bf16_launches = 0

    def counts():
        return {"k3_a": k3.fused_a_launches, "k3_b": k3.fused_b_launches,
                "k3_a_bf16": k3.fused_a_bf16_launches,
                "k3_b_bf16": k3.fused_b_bf16_launches,
                "k3_a_planes": k3.fused_a_bf16_planes_launches,
                "k2": k2.resident_cg_launches + k2.resident_dia_launches,
                "k2_bf16": k2.resident_dia_bf16_launches,
                "k5_a": k5.multi_a_launches, "k5_b": k5.multi_b_launches,
                "k5_a_bf16": k5.multi_a_bf16_launches}

    a224 = cgx_torch.poisson3d_stencil(*N224)
    cells = {"stencil 224^3": (a224, None)}
    for label in ("DIA-27 160^3", "DIA-7 192^3"):
        cells[label] = (dias[label], cgx_torch.JacobiPrecond.from_matrix(
            dias[label]))
    launches = {"a_bf16": 0, "b_bf16": 0, "a_planes": 0, "k2_bf16": 0,
                "k5_a_bf16": 0}
    errs = {}
    its_fixed = 100           # the fixed-count runs of X3 and X5

    # -- X1, X2. auto_solve(mixed_precision=True), as a user drives it -----
    ir_runs = {}
    for label, (a, m) in cells.items():
        n = a.shape[0]
        tag = "X1" if m is None else "X2"
        planes = m is not None
        if planes:
            sp = fdia.bf16_plane_speedup(a, n, 4)
            print(f"{tag} {label}: bf16_plane_speedup (the TPU model) "
                  f"{sp:.4f}, cut {BF16_PLANE_MIN_SPEEDUP}")
            check(sp >= BF16_PLANE_MIN_SPEEDUP,
                  f"{tag} {label}: the model does not choose the plane mode")
        kw = (dict(inner_dtype=torch.float32, inner_plane_dtype=bf16,
                   inner_tol=5e-3) if planes else {})
        for nm, b in (("ones", torch.ones(n, dtype=torch.float32,
                                          device=dev)),
                      ("random", seeded_rhs(n, dev))):
            zero()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = cgx_torch.auto_solve(a, b, tol=TOL, preconditioner=m,
                                       mixed_precision=True)
            end.record()
            end.synchronize()
            c = counts()
            fp32_a = c["k3_a"] - c["k3_a_bf16"] - c["k3_a_planes"]
            print(f"{tag} {label} b={nm} launches: K3 A bf16 vectors "
                  f"{c['k3_a_bf16']}, K3 B bf16 vectors {c['k3_b_bf16']}, "
                  f"K3 A bf16 planes {c['k3_a_planes']}, K3 A fp32 "
                  f"{fp32_a}, K3 B fp32 {c['k3_b'] - c['k3_b_bf16']}, K2 "
                  f"{c['k2']}, K5 A {c['k5_a']}")
            if planes:
                ok = (c["k3_a_planes"] > 0 and c["k3_a_bf16"] == 0
                      and c["k3_b_bf16"] == 0 and c["k3_b"] > 0)
                launches["a_planes"] += c["k3_a_planes"]
            else:
                ok = (c["k3_a_bf16"] > 0 and c["k3_b_bf16"] > 0
                      and c["k3_a_planes"] == 0)
                launches["a_bf16"] += c["k3_a_bf16"]
                launches["b_bf16"] += c["k3_b_bf16"]
            check(ok and fp32_a > 0 and c["k2"] == 0 and c["k5_a"] == 0,
                  f"{tag} {label} b={nm}: not the IR route's kernels: {c}")
            check(bool(res.converged), f"{tag} {label} b={nm}: not converged")
            its = int(res.iterations)
            ms = start.elapsed_time(end)
            ref = ir_cg_solve_reference(a, b, tol=TOL, maxiter=n,
                                        preconditioner=m, **kw)
            its_ref = int(ref.iterations)
            x64 = fp64_solution(label, nm, a, b)
            relres, relres_ref = relres_of(a, b, res.x), relres_of(a, b,
                                                                  ref.x)
            fwd, fwd_ref = rel(res.x, x64), rel(ref.x, x64)
            dx = rel(res.x, ref.x)
            print(f"{tag} {label} b={nm}: {its} inner iterations in "
                  f"{ms:.1f} ms (plain version {its_ref}), |x-x_plain|/"
                  f"|x_plain| {dx:.3e} (bitwise {torch.equal(res.x, ref.x)}),"
                  f" |x-x64|/|x64| {fwd:.3e} (plain {fwd_ref:.3e}), true "
                  f"relres (fp64) {relres:.3e} (plain {relres_ref:.3e})")
            # At b = ones the fp32 true residual has a floor above tol, so
            # the two-strikes guard ends the refinement on fp32 noise and
            # the fp32 finish follows: the count is held to 10 % there.
            slack = 2 if nm == "random" else max(2, its_ref // 10)
            check(abs(its - its_ref) <= slack,
                  f"{tag} {label} b={nm}: {its} vs plain {its_ref}")
            check(dx <= 1e-4, f"{tag} {label} b={nm}: x differs by {dx}")
            check(fwd <= 1e-4, f"{tag} {label} b={nm}: forward error {fwd}")
            if nm == "random":
                # b = ones: the fp32 x cannot hold 1e-6 (PERF.md §6).
                check(relres <= max(1.1e-6, 1.5 * relres_ref),
                      f"{tag} {label} b={nm}: true relres {relres}")
            ir_runs[label, nm] = (its, ms)

    # K3's narrow modes one step each at the path's shapes, bitwise.
    steps = {}
    b224 = torch.ones(a224.shape[0], dtype=torch.float32, device=dev)
    eng16 = build_fused(a224, bf16)
    p16 = seeded_rhs(a224.shape[0], dev).to(bf16)
    q, pq, qq = eng16.kernel_a(p16)
    torch.cuda.synchronize()
    q_ref, pq_ref, qq_ref = eng16.kernel_a_reference(p16)
    rz16 = torch.sum(p16.double() ** 2).float()
    x16 = (0.5 * p16.float()).to(bf16)
    out = eng16.kernel_b(rz16, pq_ref, qq_ref, x16, p16, p16, q_ref)
    torch.cuda.synchronize()
    out_ref = eng16.kernel_b_reference(rz16, pq_ref, qq_ref, x16, p16, p16,
                                       q_ref)
    errs["a_bf16"] = float((q.float() - q_ref.float()).abs().max())
    errs["b_bf16"] = max(float((g.float() - r.float()).abs().max())
                         for g, r in zip(out[:3], out_ref[:3]))
    sums = max(abs(float(g) - float(r)) / abs(float(r)) for g, r in
               ((pq, pq_ref), (qq, qq_ref)) + tuple(zip(out[3:],
                                                        out_ref[3:])))
    print(f"X1 K3 bf16 vectors one step at 224^3: A bitwise "
          f"{torch.equal(q, q_ref)}, B bitwise "
          f"{all(torch.equal(g, r) for g, r in zip(out[:3], out_ref[:3]))},"
          f" sums within {sums:.3e}")
    check(errs["a_bf16"] == 0 and errs["b_bf16"] == 0 and sums <= 1e-6,
          "X1: K3 in bf16 vectors differs from its plain version")
    first_a = {"stencil 224^3": k3a_versus_first(
        "X1", "224^3 bf16 vectors", eng16, p16, card)}
    first_b = k3b_versus_first("X1", "224^3 bf16 vectors", eng16, card,
                               rz16, pq_ref, qq_ref, x16, p16, p16, q_ref)
    k3_solve_versus_first(f"[{card}] X1", "224^3 bf16 vectors", eng16,
                          b224.to(bf16), tol=0.0, maxiter=its_fixed)
    steps["stencil 224^3"] = (eng16, build_fused(a224, torch.float32),
                              b224, p16, (rz16, pq_ref, qq_ref, x16, q_ref))
    errs["a_planes"] = 0.0
    for label in ("DIA-27 160^3", "DIA-7 192^3", "DIA-27 128^3"):
        a = dias[label]
        m = cgx_torch.JacobiPrecond.from_matrix(a)
        engp, e, _ = fdia.build_fused_dia(a, torch.float32,
                                          inv_diag=m.inv_diag,
                                          plane_dtype=bf16)
        eng32 = k3.FusedCG(engp.nx, engp.ny, engp.nz, engp.taps,
                           coeffs=engp.coeffs, planes=engp.planes.float(),
                           weight=engp.weight, sym=engp.sym)
        p = seeded_rhs(a.shape[0], dev)
        q, _, _ = engp.kernel_a(p)
        q32, _, _ = eng32.kernel_a(p)
        torch.cuda.synchronize()
        q_ref = engp.kernel_a_reference(p)[0]
        err = float((q - q_ref).abs().max())
        print(f"X2 K3 A bf16 planes one step at {label}: bitwise against "
              f"the plain version {torch.equal(q, q_ref)}, against fp32 on "
              f"the pre-rounded planes {torch.equal(q, q32)}")
        check(torch.equal(q, q_ref) and torch.equal(q, q32),
              f"X2 {label}: K3 A in bf16 planes differs")
        if label == "DIA-27 160^3":
            first_a[label] = k3a_versus_first(
                "X2", f"{label} bf16 planes", engp, p, card)
            k3_solve_versus_first(f"[{card}] X2", f"{label} bf16 planes",
                                  engp,
                                  e * torch.ones_like(p), tol=0.0,
                                  maxiter=its_fixed)
        errs["a_planes"] = max(errs["a_planes"], err)
        fp32_eng, _, _ = fdia.build_fused_dia(a, torch.float32,
                                              inv_diag=m.inv_diag)
        steps[label] = (engp, fp32_eng, e * torch.ones(
            a.shape[0], dtype=torch.float32, device=dev), p, a)

    # -- X3. K2 with bf16 planes ---------------------------------------------
    # At DIA-7 the rounded operator is indefinite (cgx_torch/solve/ir.py's
    # note): K2 in bf16 planes breaks down there, as the JAX package's
    # would, so it is held over a fixed 100 iterations; DIA-27 converges.
    k2_runs = {}
    errs["k2_bf16"] = 0.0
    for label in ("DIA-27 128^3", "DIA-7 192^3"):
        a = dias[label]
        n = a.shape[0]
        m = cgx_torch.JacobiPrecond.from_matrix(a)
        b = torch.ones(n, dtype=torch.float32, device=dev)
        fixed = label.startswith("DIA-7")
        run = (dict(tol=0.0, maxiter=its_fixed) if fixed
               else dict(tol=TOL, maxiter=n))
        zero()
        res = k2.resident_dia_cg(a, b, inv_diag=m.inv_diag, plane_dtype=bf16,
                                 **run)
        torch.cuda.synchronize()
        c = counts()
        check(c["k2_bf16"] == 1 and c["k2"] == 1 and c["k3_a"] == 0,
              f"X3 {label}: resident_dia_cg(plane_dtype=bf16) launches {c}")
        check(bool(torch.isfinite(res.x).all())
              and (fixed or bool(res.converged)),
              f"X3 {label}: not converged")
        launches["k2_bf16"] += c["k2_bf16"]
        nx, ny, nz, taps, coeffs, planes, e, w, sym = fdia.dia_prep(
            a, torch.float32, inv_diag=m.inv_diag)
        spec = (nx, ny, nz, taps, coeffs)
        pl16 = planes.to(bf16)
        g16 = k2.resident_grid(spec, dev, planes=pl16, weight=w, sym=sym)
        g32 = k2.resident_grid(spec, dev, planes=planes, weight=w, sym=sym)
        grid = min(g16, g32)
        kw = dict(weight=w, sym=sym, **run)
        b_s = e * b
        x16, _, _, k16, rz16_, _ = k2.resident_cg_call(spec, b_s, planes=pl16,
                                                       grid=grid, **kw)
        x32, _, _, k32, rz32_, _ = k2.resident_cg_call(
            spec, b_s, planes=pl16.float(), grid=grid, **kw)
        xd = k2.resident_cg_call(spec, b_s, planes=pl16, **kw)[0]
        torch.cuda.synchronize()
        x_ref, _, _, k_ref, _, _ = k2.resident_cg_reference(
            spec, b_s, planes=pl16, **kw)
        same = (int(k16) == int(k32) and torch.equal(x16, x32)
                and torch.equal(rz16_, rz32_))
        dx = rel(x16, x_ref)
        fwd = ("not held (fixed iterations)" if fixed else
               f"{rel(e * x16, fp64_solution(label, 'ones', a, b)):.3e} "
               f"(the rounded operator's solution)")
        print(f"X3 K2 bf16 planes {label} b=ones: grids {g16} (bf16) and "
              f"{g32} (fp32), run at {grid}: {int(k16)} iterations, equal "
              f"to fp32 K2 on the pre-rounded planes bit for bit: {same}; "
              f"plain version {int(k_ref)} iterations, |x-x_plain|/"
              f"|x_plain| {dx:.3e}; the entry's solve at its own grid equal "
              f"to the call at {g16}: {torch.equal(res.x, e * xd)}; "
              f"|x-x64|/|x64| {fwd}")
        check(same, f"X3 {label}: bf16 K2 differs from fp32 K2 on the "
              f"pre-rounded planes")
        # On DIA-7's indefinite operator p·q nears 0 and K2's block sums,
        # in another order than the plain version's, set the trajectory:
        # there only the bitwise check against fp32 K2 holds.
        check(fixed or (abs(int(k16) - int(k_ref)) <= 2 and dx <= 1e-4),
              f"X3 {label}: K2 bf16 against its plain version")
        if not fixed:
            errs["k2_bf16"] = float((x16 - x_ref).abs().max())
        k2_runs[label] = (spec, b_s, pl16, planes, kw, int(k16), g16, g32)

    # -- X4. K5 with bf16 planes ---------------------------------------------
    d160 = dias["DIA-27 160^3"]
    n = d160.shape[0]
    m = cgx_torch.JacobiPrecond.from_matrix(d160)
    B = seeded_block(n, K_MULTI, SEED + 4, dev)
    zero()
    res = k5.fused_dia_cg_multi(d160, B, tol=TOL, maxiter=n,
                                inv_diag=m.inv_diag, plane_dtype=bf16)
    torch.cuda.synchronize()
    c = counts()
    check(c["k5_a_bf16"] > 0 and c["k5_a_bf16"] == c["k5_a"]
          and c["k5_b"] > 0 and c["k3_a"] == 0 and c["k2"] == 0,
          f"X4: fused_dia_cg_multi(plane_dtype=bf16) launches {c}")
    launches["k5_a_bf16"] = c["k5_a_bf16"]
    nx, ny, nz, taps, coeffs, planes, e, w, sym = fdia.dia_prep(
        d160, torch.float32, inv_diag=m.inv_diag)
    e160 = e
    eng5 = k5.FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs, planes=planes,
                           weight=w, sym=sym, plane_dtype=bf16)
    pre = k5.FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs,
                          planes=eng5.planes.float(), weight=w, sym=sym)
    r_pre = pre.solve((B.T * e[None]).contiguous(), tol=TOL, maxiter=n)
    x_pre = r_pre.x * e[:, None]
    cols = [torch.equal(res.x[:, j], x_pre[:, j]) for j in range(K_MULTI)]
    P = seeded_block(n, K_MULTI, SEED + 3, dev).T.contiguous()
    q5, _, _ = eng5.kernel_a(P)
    torch.cuda.synchronize()
    q5_ref = eng5.kernel_a_reference(P)[0]
    errs["k5_a_bf16"] = float((q5 - q5_ref).abs().max())
    print(f"X4 K5 bf16 planes DIA-27 160^3, B ({n}, {K_MULTI}): "
          f"{int(res.iterations[0])} iterations shared (fp32 on the "
          f"pre-rounded planes {int(r_pre.iterations[0])}), each column "
          f"equal to it bit for bit: {cols}; converged "
          f"{res.converged.tolist()}; one step of K5 A against its plain "
          f"version bitwise: {torch.equal(q5, q5_ref)}")
    check(all(cols) and torch.equal(res.iterations, r_pre.iterations),
          "X4: K5 bf16 differs from fp32 K5 on the pre-rounded planes")
    check(torch.equal(q5, q5_ref), "X4: K5 A bf16 differs from its plain "
          "version")

    # -- X5. Times -------------------------------------------------------------
    per_iter, dev_us = {}, {}
    for label, (eng_n, eng_f, b_s, p, *_rest) in steps.items():
        b_n = b_s.to(eng_n.dtype)
        its_n = int(eng_n.solve(b_n, tol=0.0, maxiter=its_fixed).iterations)
        its_f = int(eng_f.solve(b_s, tol=0.0, maxiter=its_fixed).iterations)
        check(its_n == its_f == its_fixed,
              f"X5 {label}: {its_n} and {its_f} of {its_fixed} iterations")
        t_n, t_f = time_pair(
            lambda: eng_n.solve(b_n, tol=0.0, maxiter=its_fixed),
            lambda: eng_f.solve(b_s, tol=0.0, maxiter=its_fixed), reps=3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng_n.solve(b_n, tol=0.0, maxiter=its_fixed)
            torch.cuda.synchronize()
        ua, na = device_us(prof, lambda kk: "kernel_a2<" in kk
                           and "bfloat16" in kk)
        ub, nb = device_us(prof, lambda kk: "kernel_b2<" in kk)
        check(na > 0 and nb > 0, f"X5 {label}: the profiler recorded no "
              "device time for K3")
        dev_us[label] = (ua / max(na, 1), ub / max(nb, 1))
        per_iter[label] = (t_n / its_fixed * 1e3, t_f / its_fixed * 1e3)
        pred = ("" if label.startswith("stencil") else
                f"; bf16_plane_speedup (TPU model) "
                f"{fdia.bf16_plane_speedup(_rest[-1], eng_n.n, 4):.3f}")
        mode = ("bf16 vectors" if eng_n.dtype == bf16 else
                "bf16 planes, fp32 vectors")
        print(f"[{card}] X5 K3 {label}, {its_fixed} iterations: {mode} "
              f"{per_iter[label][0]:.2f} us/iter, fp32 "
              f"{per_iter[label][1]:.2f} us/iter, measured fp32/narrow "
              f"{t_f / t_n:.3f}{pred}; device time per launch (profiler, "
              f"narrow): A {dev_us[label][0]:.2f} us, B "
              f"{dev_us[label][1]:.2f} us")

    # The probe ir_cg_solve takes before refining: the smoothest grid
    # mode's Rayleigh quotient under the bf16-plane and the fp32 engine.
    for label, (engp, eng32, *_rest) in steps.items():
        if engp.dtype == bf16:
            continue
        axes = [torch.sin(torch.pi * torch.arange(
            1, m_ + 1, dtype=torch.float64, device=dev) / (m_ + 1))
            for m_ in (engp.nx, engp.ny, engp.nz)]
        v = torch.einsum("i,j,k->ijk", *axes).reshape(-1).float()
        rq16, rq32 = (float(v.double() @ e_.kernel_a(v)[0].double())
                      / float(v.double() @ v.double())
                      for e_ in (engp, eng32))
        print(f"X5 smoothest-mode Rayleigh quotient at {label}: bf16 "
              f"planes {rq16:.4e}, fp32 {rq32:.4e}, ratio "
              f"{rq16 / rq32:.3f} (IR refines only at >= 0.5)")

    # Fault C2: torch's index_add_ (the CSR product before the port's
    # row-ordered sum) against row_sum, ten runs each, at poisson3d 128^3.
    from cgx_torch.io.poisson import poisson3d
    from cgx_torch.ops.spmv import row_sum

    a3 = poisson3d(*N128, dtype=np.float32, device=dev)
    prods = a3.values * seeded_rhs(a3.shape[0], dev)[a3.col_indices]

    def by_index_add():
        return torch.zeros(a3.shape[0], device=dev).index_add_(
            0, a3.row_indices, prods)

    def by_row_sum():
        return row_sum(a3.row_indices, prods, a3.shape[0], True)

    outs = {name: {fn().cpu().numpy().tobytes() for _ in range(10)}
            for name, fn in (("index_add_", by_index_add),
                             ("row_sum", by_row_sum))}
    t_rs, t_ia = time_pair(by_row_sum, by_index_add, inner=5)
    print(f"[{card}] X5 CSR product of poisson3d 128^3: index_add_ "
          f"{len(outs['index_add_'])} distinct results in 10 runs, "
          f"{t_ia * 1e3:.1f} us; row_sum {len(outs['row_sum'])}, "
          f"{t_rs * 1e3:.1f} us")
    check(len(outs["row_sum"]) == 1, "row_sum is not reproducible")
    del a3, prods

    # One call of each narrow kernel beside its plain version.
    eng16, _, _, p16, (rz16, pq_ref, qq_ref, x16, q_ref) = steps[
        "stencil 224^3"]
    t_a16, t_a16p = time_pair(lambda: eng16.kernel_a(p16),
                              lambda: eng16.kernel_a_reference(p16), inner=10)
    t_b16, t_b16p = time_pair(
        lambda: eng16.kernel_b(rz16, pq_ref, qq_ref, x16, p16, p16, q_ref),
        lambda: eng16.kernel_b_reference(rz16, pq_ref, qq_ref, x16, p16, p16,
                                         q_ref), inner=10)
    engp, _, _, pp, _ = steps["DIA-27 160^3"]
    t_ap, t_app = time_pair(lambda: engp.kernel_a(pp),
                            lambda: engp.kernel_a_reference(pp), inner=10)
    t_5, t_5p = time_pair(lambda: eng5.kernel_a(P),
                          lambda: eng5.kernel_a_reference(P), inner=5)
    first_a["K5"] = k5a_versus_first("X5", "DIA-27 160^3 bf16 planes", eng5,
                                     P, card)
    print(f"[{card}] X5 one call from Python: K3 A bf16 vectors 224^3 "
          f"{t_a16 * 1e3:.2f} us (plain {t_a16p * 1e3:.2f}), K3 B bf16 "
          f"vectors {t_b16 * 1e3:.2f} us (plain {t_b16p * 1e3:.2f}; the "
          f"call copies x, r, p first), K3 A bf16 planes DIA-27 160^3 "
          f"{t_ap * 1e3:.2f} us (plain {t_app * 1e3:.2f}), K5 A bf16 "
          f"planes DIA-27 160^3 k={K_MULTI} {t_5 * 1e3:.2f} us (plain "
          f"{t_5p * 1e3:.2f}; device {first_a['K5'][0] * 1e3:.2f} us per "
          f"call)")

    # K2: 100 iterations (tol 0) in bf16 planes beside fp32, each at its
    # own grid, and the plain version of the same run.
    k2_ms = {}
    for label, (spec, b_s, pl16, planes, kw, its16, g16, g32) in \
            k2_runs.items():
        kf = dict(kw, tol=0.0, maxiter=its_fixed)
        t16, t32 = time_pair(
            lambda: k2.resident_cg_call(spec, b_s, planes=pl16, **kf),
            lambda: k2.resident_cg_call(spec, b_s, planes=planes, **kf),
            reps=3)
        tp = event_ms(lambda: k2.resident_cg_reference(spec, b_s,
                                                       planes=pl16, **kf))
        k2_ms[label] = (t16, tp)
        print(f"[{card}] X5 K2 {label} b=ones, {its_fixed} iterations: bf16 "
              f"planes {t16:.3f} ms, {t16 / its_fixed * 1e3:.2f} us/iter "
              f"(grid {g16}); fp32 {t32:.3f} ms, "
              f"{t32 / its_fixed * 1e3:.2f} us/iter (grid {g32}); fp32/bf16 "
              f"{t32 / t16:.3f}; plain {tp:.1f} ms")

    # IR per inner iteration beside the fp32 solves (K3 and K2), b = ones.
    for label, (a, m) in cells.items():
        n = a.shape[0]
        b = torch.ones(n, dtype=torch.float32, device=dev)
        its_ir = ir_runs[label, "ones"][0]
        eng32 = steps[label][1]
        e = (None if m is None else fdia.dia_prep(
            a, torch.float32, inv_diag=m.inv_diag)[6])
        b_s = b if e is None else e * b
        its32 = int(eng32.solve(b_s, tol=TOL, maxiter=n).iterations)
        its_k2 = int(cgx_torch.auto_solve(a, b, tol=TOL,
                                          preconditioner=m).iterations)
        t_ir, t_32 = time_pair(
            lambda: cgx_torch.auto_solve(a, b, tol=TOL, preconditioner=m,
                                         mixed_precision=True),
            lambda: eng32.solve(b_s, tol=TOL, maxiter=n), reps=3)
        t_k2 = statistics.median(event_ms(lambda: cgx_torch.auto_solve(
            a, b, tol=TOL, preconditioner=m)) for _ in range(3))
        print(f"[{card}] X5 IR {label} b=ones: {t_ir:.2f} ms, {its_ir} inner "
              f"iterations, {t_ir / its_ir * 1e3:.2f} us per inner "
              f"iteration; fp32 K3 {t_32:.2f} ms, {its32} iterations, "
              f"{t_32 / its32 * 1e3:.2f} us/iter; fp32 K2 (auto_solve "
              f"without mixed_precision) {t_k2:.2f} ms, {its_k2} iterations;"
              f" IR / K3 {t_ir / t_32:.3f}, IR / K2 {t_ir / t_k2:.3f}")

    # PyTorch calls computing the same functions: conv3d in bf16 (K3 A's
    # stencil product) and the CSR product of Ã with its values rounded
    # through bf16 (K3 A's and K5 A's plane-mode products).
    wk = torch.zeros((1, 1, 3, 3, 3), device=dev, dtype=bf16)
    wk[0, 0, 1, 1, 1] = 6.0
    for tap in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                (1, 1, 2)):
        wk[(0, 0) + tap] = -1.0
    xv = p16.view(1, 1, *N224)

    def conv():
        return torch.nn.functional.conv3d(xv, wk, padding=1)

    q16 = eng16.kernel_a_reference(p16)[0]
    check(maxrel(conv().reshape(-1), q16) <= 2.0 ** -6,
          "bf16 conv3d does not compute K3 A's bf16 product")
    conv()
    t_conv = statistics.median(event_ms(conv, inner=10) for _ in range(5))
    csr = scaled_csr(d160, e160)
    csr16 = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                    csr.values().to(bf16).float(),
                                    size=csr.shape)
    del csr
    qp = engp.kernel_a_reference(pp)[0]
    pc = pp[:, None]
    # The CSR takes each value from its own triangle, the symmetric engine
    # mirrors the upper one: fp32 values an ulp apart can round a bf16 ulp
    # apart, so the same function is held to 2⁻⁸ here.
    check(maxrel((csr16 @ pc)[:, 0], qp) <= 2.0 ** -8,
          "the CSR product does not compute K3 A's bf16-plane product")
    t_csr = statistics.median(event_ms(lambda: csr16 @ pc, inner=10)
                              for _ in range(5))
    pn = P.T.contiguous()
    t_csr5 = statistics.median(event_ms(lambda: csr16 @ pn, inner=5)
                               for _ in range(3))
    del csr16
    print(f"[{card}] X5 PyTorch calls: conv3d bf16 at 224^3 "
          f"{t_conv * 1e3:.2f} us; CSR product of Ã (bf16-rounded values) "
          f"at DIA-27 160^3, k=1 {t_csr * 1e3:.2f} us, k={K_MULTI} "
          f"{t_csr5 * 1e3:.2f} us")

    # Bounds: each input read once and each output written once, 2 B per
    # bf16 value and 4 B per fp32 one, against the fp32 operations.
    n224 = a224.shape[0]
    n_pl = engp.planes.shape[0]
    n160 = engp.n
    terms = sum(2 if (c is None and engp.sym and tap != (0, 0, 0)) else 1
                for tap, c in zip(engp.taps, engp.coeffs))
    b_a16 = bound(4 * n224, n224 * (2 * 7 + 4))
    b_b16 = bound(14 * n224, 12 * n224)
    b_ap = bound((2 * n_pl + 8) * n160, n160 * (2 * terms + 4))
    b_5 = bound((2 * n_pl + 8 * K_MULTI) * n160,
                K_MULTI * n160 * (2 * terms + 4))
    spec27, _, pl27, _, _, _, _, _ = k2_runs["DIA-27 128^3"]
    n128 = N128[0] * N128[1] * N128[2]
    b_k2 = bound((2 * pl27.shape[0] + 12) * n128,
                 its_fixed * n128 * (2 * len(spec27[3]) + 12))
    print(f"X5 bounds: K3 A bf16 {b_a16[0] * 1e3:.2f} us ({b_a16[1]}), K3 B "
          f"bf16 {b_b16[0] * 1e3:.2f} us, K3 A bf16 planes DIA-27 160^3 "
          f"{b_ap[0] * 1e3:.2f} us, K5 A bf16 planes {b_5[0] * 1e3:.2f} us,"
          f" K2 bf16 planes DIA-27 128^3 {b_k2[0]:.3f} ms per "
          f"{its_fixed} iterations ({b_k2[1]})")

    def entry(name, source, replaces, nl, err, ms, plain_ms, b, lib,
              **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": nl, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
                "bound_by": b[1], "library_ms": lib, **extra}

    eng_src = "cgx_torch/csrc/fused_engine.cu"
    return [
        entry("fused_kernel_a_bf16", eng_src,
              "cgx/kernels/fused_engine.py:272", launches["a_bf16"],
              errs["a_bf16"], first_a["stencil 224^3"][0], t_a16p,
              b_a16, t_conv, before_ms=first_a["stencil 224^3"][1]),
        entry("fused_kernel_b_bf16", eng_src,
              "cgx/kernels/fused_engine.py:411", launches["b_bf16"],
              errs["b_bf16"], first_b[0], t_b16p, b_b16, None,
              before_ms=first_b[1]),
        entry("fused_kernel_a_bf16_planes", eng_src,
              "cgx/kernels/fused_engine.py:272", launches["a_planes"],
              errs["a_planes"], first_a["DIA-27 160^3"][0], t_app,
              b_ap, t_csr, before_ms=first_a["DIA-27 160^3"][1]),
        entry("resident_cg_planes_bf16", "cgx_torch/csrc/resident_cg.cu",
              "cgx/kernels/fused_resident.py:115", launches["k2_bf16"],
              errs["k2_bf16"], k2_ms["DIA-27 128^3"][0],
              k2_ms["DIA-27 128^3"][1], b_k2, None),
        entry("fused_multi_a_bf16_planes", "cgx_torch/csrc/fused_multi.cu",
              "cgx/kernels/fused_multi.py:64", launches["k5_a_bf16"],
              errs["k5_a_bf16"], first_a["K5"][0], t_5p, b_5, t_csr5,
              before_ms=first_a["K5"][1]),
    ]


def sr_phases(dev, card, dias, fp64_solution, relres_of):
    """S1–S5: the semi-resident whole solve K4 (``auto_solve(...,
    backend="sr_stencil" | "sr_dia")``, ``sr_stencil_cg`` and
    ``sr_dia_cg`` in each tier, resume) and the one-pass engine K6
    (``fused_stencil_cg(..., one_pass=True)``), each held against K3's
    solve bit for bit, against its plain version and an fp64 solve, and
    against a second run; then their times beside K3 and K2.  ``dias``
    holds DIA-27 128³; ``fp64_solution`` and ``relres_of`` are the main
    phases' yardsticks.  Returns the report line's entries of K4 and K6."""
    import cgx_torch
    from cgx_torch.kernels import _build
    from cgx_torch.kernels import fused_dia_cg as fdia
    from cgx_torch.kernels import fused_engine as k3
    from cgx_torch.kernels import fused_onepass as k6
    from cgx_torch.kernels import fused_resident as k2
    from cgx_torch.kernels import fused_semiresident as k4
    from cgx_torch.kernels.fused_cg import (build_fused, fused_stencil_cg,
                                            stencil_taps)
    from torch.profiler import ProfilerActivity, profile

    bf16 = torch.bfloat16

    def zero():
        k4.sr_cg_launches = k4.sr_cg_planes_launches = 0
        k4.sr_cg_first_launches = k4.sr_cg_bf16_launches = 0
        k2.resident_cg_launches = k2.resident_dia_launches = 0
        k3.fused_a_launches = k3.fused_b_launches = 0
        k6.onepass_launches = 0

    def counts():
        return {"k4": k4.sr_cg_launches, "k4_planes": k4.sr_cg_planes_launches,
                "k4_first": k4.sr_cg_first_launches,
                "k4_bf16": k4.sr_cg_bf16_launches,
                "k2": k2.resident_cg_launches + k2.resident_dia_launches,
                "k3_a": k3.fused_a_launches, "k3_b": k3.fused_b_launches,
                "k6": k6.onepass_launches}

    def same(label, res, ref, history=False):
        ok = (int(res.iterations) == int(ref.iterations)
              and torch.equal(res.x, ref.x)
              and (not history or torch.equal(res.history, ref.history)))
        print(f"{label}: {int(res.iterations)} iterations, bit for bit "
              f"equal to K3: {ok}")
        check(ok, f"{label}: differs from K3 ({int(res.iterations)} vs "
              f"{int(ref.iterations)} iterations)")

    # The K4 kernel a solve ran, by its launch counters: sr2_kernel (the
    # redesign) or sr_kernel (the first design).
    kernel_of = {"k4": "sr2_kernel", "k4_planes": "sr2_kernel",
                 "k4_first": "sr_kernel"}

    def k4_run(fn):
        before = counts()
        res = fn()
        after = counts()
        ran = [kernel_of[k] for k in kernel_of if after[k] != before[k]]
        check(len(ran) == 1, f"a K4 solve launched {ran}")
        return res, ran[0]

    def k4_expected(g, eng):
        return ("sr_kernel" if k4._design_for(g, eng) == k4._FIRST_DESIGN
                else "sr2_kernel")

    def rhs(n, nm):
        return (torch.ones(n, dtype=torch.float32, device=dev)
                if nm == "ones" else seeded_rhs(n, dev))

    def same_first(label, res, first, scale=None):
        # The first design's kernel (the "before", counted nowhere).
        x = first.x if scale is None else scale * first.x
        ok = (int(res.iterations) == int(first.iterations)
              and torch.equal(res.x, x)
              and torch.equal(res.residual_norm_sq, first.residual_norm_sq))
        print(f"{label}: equal to the first K4 design bit for bit (x, "
              f"iterations, rw): {ok}")
        check(ok, f"{label}: K4 differs from its first design")

    # -- S1: sr_stencil as a user drives it --------------------------------
    stencils = {dims[0]: cgx_torch.poisson3d_stencil(*dims)
                for dims in (N160, N216, N288)}
    N1, N2, N3 = N160[0], N216[0], N288[0]
    s1_cases = [("auto", N1, None), ("rpq", N1, "rpq"), ("rp", N2, "rp"),
                ("p", N3, "p")]
    plan = [k4.sr_mode(*dims, stencil_taps(stencils[dims[0]])[3])
            for dims in (N160, N216, N288)]
    print(f"S1 the card's tier plan: 160^3 {plan[0]}, 216^3 {plan[1]}, "
          f"288^3 {plan[2]}")
    check(plan == ["rpq", "p", None], "the card's tier plan moved")
    zero()
    s1 = []
    for kind, N, mode in s1_cases:
        a = stencils[N]
        for nm in ("ones", "random"):
            b = rhs(a.shape[0], nm)
            if kind == "auto":
                res = cgx_torch.auto_solve(a, b, tol=TOL,
                                           backend="sr_stencil")
            else:
                res = k4.sr_stencil_cg(a, b, tol=TOL, maxiter=a.shape[0],
                                       mode=mode)
            torch.cuda.synchronize()
            check(bool(res.converged), f"S1 {kind} {N}^3 b={nm} did not "
                  f"converge")
            s1.append((kind, N, mode, nm, b, res))
    c = counts()
    print(f"S1 launches: K4 {c['k4']}, K2 {c['k2']}, K3 A {c['k3_a']}, "
          f"K6 {c['k6']}")
    check(c["k4"] == len(s1) and c["k2"] == 0 and c["k3_a"] == 0
          and c["k6"] == 0, f"S1 did not run through K4 alone: {c}")
    launches = {"sr_cg": c["k4"]}

    err_k4 = 0.0
    plain_ms = {}
    for kind, N, mode, nm, b, res in s1:
        a = stencils[N]
        n = a.shape[0]
        label = f"S1 {kind} {N}^3 b={nm}"
        same(label, res, fused_stencil_cg(a, b, tol=TOL, maxiter=n))
        nx, ny, nz, taps, coeffs = stencil_taps(a)
        g = k4.make_sr_geometry(nx, ny, nz, taps, mode=mode)
        same_first(label, res, k4._before_solve(g, b, coeffs=coeffs, tol=TOL,
                                                maxiter=n))
        t0 = time.perf_counter()
        x_ref, _, _, k_ref, _, _ = k4.sr_cg_reference(
            g, b, coeffs=coeffs, tol=TOL, maxiter=n)
        torch.cuda.synchronize()
        plain_ms[N, nm] = (time.perf_counter() - t0) * 1e3
        x64 = fp64_solution(f"stencil {N}^3", nm, a, b)
        hold(f"K4 {label} ({g.mode})", res.x, int(res.iterations), x_ref,
             int(k_ref), relres_of(a, b, res.x), relres_of(a, b, x_ref),
             rel(res.x, x64), rel(x_ref, x64))
        err_k4 = max(err_k4, float((res.x - x_ref).abs().max()))
        again = (cgx_torch.auto_solve(a, b, tol=TOL, backend="sr_stencil")
                 if kind == "auto" else
                 k4.sr_stencil_cg(a, b, tol=TOL, maxiter=n, mode=mode))
        check(torch.equal(again.x, res.x)
              and int(again.iterations) == int(res.iterations),
              f"{label}: two K4 runs differ")

    # -- S2: sr_dia ----------------------------------------------------------
    t0 = time.perf_counter()
    d7 = scaled_dia7(N160, dev)
    print(f"DIA-7 160^3 built in {time.perf_counter() - t0:.1f} s")
    s2_ops = {"DIA-7 160^3": d7, "DIA-27 128^3": dias["DIA-27 128^3"]}
    jac = {lb: cgx_torch.JacobiPrecond.from_matrix(a)
           for lb, a in s2_ops.items()}
    zero()
    s2 = []
    for label, a in s2_ops.items():
        for nm in ("ones", "random"):
            b = rhs(a.shape[0], nm)
            check(k4.sr_dia_supported(a), f"{label}: no tier planned")
            res, ran = k4_run(lambda a=a, b=b, label=label: (
                cgx_torch.auto_solve(a, b, tol=TOL,
                                     preconditioner=jac[label],
                                     backend="sr_dia")))
            s2.append((label, "rpq", None, nm, b, res, ran))
    b7 = rhs(d7.shape[0], "ones")
    for mode in ("rp", "p"):
        res, ran = k4_run(lambda mode=mode: k4.sr_dia_cg(
            d7, b7, tol=TOL, maxiter=d7.shape[0],
            inv_diag=jac["DIA-7 160^3"].inv_diag, mode=mode))
        s2.append(("DIA-7 160^3", mode, None, "ones", b7, res, ran))
    d27 = s2_ops["DIA-27 128^3"]
    b27 = rhs(d27.shape[0], "ones")
    res, ran = k4_run(lambda: k4.sr_dia_cg(
        d27, b27, tol=TOL, maxiter=d27.shape[0],
        inv_diag=jac["DIA-27 128^3"].inv_diag, plane_dtype=bf16))
    s2.append(("DIA-27 128^3", "rpq", bf16, "ones", b27, res, ran))
    torch.cuda.synchronize()
    c = counts()
    print(f"S2 launches: K4 planes {c['k4_planes']} (sr2_kernel), first "
          f"design {c['k4_first']} (sr_kernel), bf16 planes {c['k4_bf16']}, "
          f"K4 const {c['k4']}, K2 {c['k2']}, K3 A {c['k3_a']}")
    check(c["k4_planes"] + c["k4_first"] == len(s2) and c["k4_planes"] > 0
          and c["k4_first"] > 0 and c["k4_bf16"] == 1 and c["k4"] == 0
          and c["k2"] == 0 and c["k3_a"] == 0,
          f"S2 did not run through K4's planes mode alone: {c}")
    launches["sr_cg_planes"] = c["k4_planes"]
    launches["sr_cg_first"] = c["k4_first"]

    err_k4p = {"sr2_kernel": 0.0, "sr_kernel": 0.0}
    for label, mode, pdt, nm, b, res, ran in s2:
        a, m = s2_ops[label], jac[label]
        n = a.shape[0]
        tag = (f"S2 {label} {mode} b={nm}"
               + (" bf16 planes" if pdt is not None else ""))
        check(bool(res.converged), f"{tag} did not converge")
        same(tag, res, fdia.fused_dia_cg(a, b, tol=TOL, maxiter=n,
                                         inv_diag=m.inv_diag,
                                         plane_dtype=pdt))
        nx, ny, nz, taps, coeffs, planes, e, w, sym = fdia.dia_prep(
            a, torch.float32, inv_diag=m.inv_diag)
        g = k4.make_sr_geometry(nx, ny, nz, taps, mode=mode,
                                n_planes=planes.shape[0], weighted=True,
                                sym=sym)
        want = k4_expected(g, k3.FusedCG(nx, ny, nz, taps, coeffs=coeffs,
                                         planes=planes, weight=w, sym=sym,
                                         plane_dtype=pdt))
        print(f"{tag}: ran {ran} (the instance's kernel: {want})")
        check(ran == want, f"{tag}: ran {ran}, not {want}")
        kw = dict(coeffs=coeffs, w=w, tol=TOL, maxiter=n,
                  b_norm_sq=torch.sum(b * b))
        same_first(tag, res, k4._before_solve(g, e * b, planes=planes,
                                              plane_dtype=pdt, **kw), e)
        t0 = time.perf_counter()
        xs, _, _, k_ref, _, _ = k4.sr_cg_reference(
            g, e * b, planes=planes, plane_dtype=pdt, **kw)
        torch.cuda.synchronize()
        if pdt is None and mode == "rpq":
            plain_ms[label, nm] = (time.perf_counter() - t0) * 1e3
        x_ref = e * xs
        err_k4p[ran] = max(err_k4p[ran], float((res.x - x_ref).abs().max()))
        if pdt is None:
            x64 = fp64_solution(label, nm, a, b)
            hold(f"K4 {tag}", res.x, int(res.iterations), x_ref, int(k_ref),
                 relres_of(a, b, res.x), relres_of(a, b, x_ref),
                 rel(res.x, x64), rel(x_ref, x64))
        else:
            # bf16 planes solve the rounded operator: held to the plain
            # version, and to fp32 K4 on the planes rounded through bf16 at
            # one partition, bit for bit.
            dx = rel(res.x, x_ref)
            print(f"K4 {tag}: {int(res.iterations)} iterations (plain "
                  f"{int(k_ref)}), |x-x_plain|/|x_plain| {dx:.3e}")
            check(abs(int(res.iterations) - int(k_ref)) <= 2 and dx <= 1e-4,
                  f"{tag}: differs from the plain version")
            grids = k3.FusedCG(nx, ny, nz, taps, coeffs=coeffs,
                               planes=planes, weight=w,
                               sym=sym).grids(dev)
            narrow = k4.sr_cg(g, e * b, planes=planes, plane_dtype=bf16,
                              grids=grids, **kw)
            pre = k4.sr_cg(g, e * b, planes=planes.to(bf16).float(),
                           grids=grids, **kw)
            ok = (int(narrow.iterations) == int(pre.iterations)
                  and torch.equal(narrow.x, pre.x))
            print(f"K4 {tag}: equal to fp32 K4 on the pre-rounded planes at "
                  f"grids {grids}: {ok}")
            check(ok, f"{tag}: differs from fp32 K4 on pre-rounded planes")
        again = k4.sr_dia_cg(a, b, tol=TOL, maxiter=n, inv_diag=m.inv_diag,
                             mode=mode, plane_dtype=pdt)
        check(torch.equal(again.x, res.x), f"{tag}: two K4 runs differ")

    # -- S3: resume ----------------------------------------------------------
    a = stencils[N1]
    nx, ny, nz, taps, coeffs = stencil_taps(a)
    b = rhs(a.shape[0], "random")
    for mode, split in (("rpq", 100), ("rp", 101)):
        g = k4.make_sr_geometry(nx, ny, nz, taps, mode=mode)
        full = k4.sr_cg_call(g, b, coeffs=coeffs, tol=TOL, maxiter=5000)
        x, r, p, k, rz, _ = k4.sr_cg_call(g, b, coeffs=coeffs, tol=TOL,
                                          maxiter=split)
        rest = k4.sr_cg_call(g, b, coeffs=coeffs, tol=TOL,
                             maxiter=5000 - split,
                             resume=(x, r, p, rz[0], rz[1]))
        ok = (int(k) == split and int(k) + int(rest[3]) == int(full[3])
              and all(torch.equal(u, v) for u, v in
                      zip(rest[:3] + rest[4:5], full[:3] + full[4:5])))
        print(f"S3 {mode} {N1}^3: {split} + {int(rest[3])} iterations resumed "
              f"equal one call of {int(full[3])}, bit for bit: {ok}")
        check(ok, f"S3 {mode}: the resumed solve differs from one call")
        # The first design from the same split state, and in one call.
        old = k4._before_call(g, b, coeffs=coeffs, tol=TOL,
                              maxiter=5000 - split,
                              resume=(x, r, p, rz[0], rz[1]))
        old_full = k4._before_call(g, b, coeffs=coeffs, tol=TOL,
                                   maxiter=5000)
        ok = all(int(u[3]) == int(v[3]) and all(
            torch.equal(s_, t_) for s_, t_ in zip(u[:3] + u[4:5],
                                                  v[:3] + v[4:5]))
                 for u, v in ((old, rest), (old_full, full)))
        print(f"S3 {mode} {N1}^3: the first K4 design resumed and in one "
              f"call equal the redesign's, bit for bit: {ok}")
        check(ok, f"S3 {mode}: K4 differs from its first design")

    # -- S4: the one-pass engine K6 --------------------------------------------
    a224 = cgx_torch.poisson3d_stencil(*N224)
    n224 = a224.shape[0]
    zero()
    s4 = []
    for nm in ("ones", "random"):
        b = rhs(n224, nm)
        for hist in (False, True):
            res = fused_stencil_cg(a224, b, tol=TOL, maxiter=MAXIT_HIST,
                                   track_history=hist, one_pass=True)
            torch.cuda.synchronize()
            check(bool(res.converged), f"S4 b={nm} did not converge")
            s4.append((nm, hist, b, res))
    c = counts()
    its_all = sum(int(r.iterations) for *_, r in s4)
    print(f"S4 launches: K6 {c['k6']} for {its_all} iterations, K3 A "
          f"{c['k3_a']} (init), K3 B {c['k3_b']}, K4 {c['k4']}, K2 {c['k2']}")
    check(c["k6"] >= its_all + len(s4) and c["k3_a"] == len(s4)
          and c["k3_b"] == 0 and c["k4"] == 0 and c["k2"] == 0,
          f"S4 did not run through K6: {c}")
    launches["onepass"] = c["k6"]
    eng6 = build_fused(a224, torch.float32, one_pass=True)
    err_k6 = 0.0
    for nm, hist, b, res in s4:
        label = f"S4 224^3 b={nm}" + (" history" if hist else "")
        kw = dict(tol=TOL, maxiter=MAXIT_HIST, track_history=hist)
        same(label, res, fused_stencil_cg(a224, b, **kw), history=hist)
        ref = eng6.solve_reference(b, **kw)
        x64 = fp64_solution("stencil 224^3", nm, a224, b)
        hold(f"K6 {label}", res.x, int(res.iterations), ref.x,
             int(ref.iterations), relres_of(a224, b, res.x),
             relres_of(a224, b, ref.x), rel(res.x, x64), rel(ref.x, x64))
        err_k6 = max(err_k6, float((res.x - ref.x).abs().max()))
        if hist:
            k = min(int(res.iterations), int(ref.iterations))
            h, h_ref = res.history[:k + 1], ref.history[:k + 1]
            hdev = float(((h - h_ref).abs() / h_ref.abs()).max())
            print(f"K6 {label}: history within {hdev:.3e} of the plain "
                  f"version's (bound 2e-2)")
            check(hdev <= 2e-2, f"K6 {label}: history differs by {hdev}")
        again = fused_stencil_cg(a224, b, one_pass=True, **kw)
        check(torch.equal(again.x, res.x)
              and torch.equal(again.history, res.history),
              f"{label}: two K6 runs differ")
        # The first design's kernel (the "before", counted nowhere).
        first = k6._before_solve(eng6, b, **kw)
        same(f"{label} first K6 design", first, res, history=hist)
    grid6, ga6, gb6 = eng6.shape(dev)
    print(f"S4 K6 grid {grid6} over K3's grids ga {ga6} and gb {gb6} (every "
          f"block sweeps {ga6 / grid6:g} and {gb6 / grid6:g} virtual "
          f"blocks); the first design's grid "
          f"{eng6._occupancy(_build.library(), dev, k6._FIRST_DESIGN)}")

    # -- S5: times -----------------------------------------------------------
    # Per iteration, b = ones: K4 beside its first design (the same call
    # through sr_kernel) and K3 in turns, events around a solve (one
    # launch of K4 each), medians of 5; K2 separately; the plain versions'
    # solves were timed once above (host clock, synchronised).  On a DIA
    # operator all three run on the planes of one dia_prep (K3 on its
    # prepared engine, K2 through resident_cg_call), whose own time is
    # printed apart.
    def k4_turns(label, a, g, b, kw, eng, k3_solve, k2_solve):
        n = a.shape[0]
        res, ran = k4_run(lambda: k4.sr_cg(g, b, **kw))
        its = int(res.iterations)
        check(ran == k4_expected(g, eng), f"S5 {label} {g.mode}: ran {ran}")
        t4, t4_old, t3 = time_set([
            lambda: k4.sr_cg(g, b, **kw),
            lambda: k4._before_solve(g, b, **kw), k3_solve], reps=5)
        r2 = k2_solve()
        its2 = int(r2.iterations if hasattr(r2, "iterations") else r2[3])
        t2 = statistics.median(event_ms(k2_solve) for _ in range(3))
        ga, gb = eng.grids(dev)
        grid = k4.sr_launch_grid(g, eng, dev, ga, gb)
        n_pl = 0 if eng.planes is None else eng.planes.shape[0]
        streams = (k4.STREAMS[g.mode] + int(eng.weight is not None)
                   + n_pl * (1 if g.mode == "rpq" else 2))
        us = t4 / its * 1e3
        print(f"[{card}] S5 {label} {g.mode} b=ones ({its} it; K4 ran "
              f"{ran}): K4 "
              f"{t4:.3f} ms, {us:.2f} us/iter; first K4 design "
              f"{t4_old / its * 1e3:.2f} us/iter ({t4 / t4_old:.3f}), K3 "
              f"{t3 / its * 1e3:.2f} us/iter ({t4 / t3:.3f}), in turns; K2 "
              f"{t2 / its2 * 1e3:.2f} us/iter ({its2} it; K2/K4 "
              f"{t2 / its2 / (t4 / its):.3f}); floor "
              f"{floor_us(streams, n):.1f} us/iter ({streams} streams); "
              f"grid {grid} over K3's ga {ga}, gb {gb} (first design "
              f"{k4._occupancy(_build.library(), dev, g, eng, 0)})")
        return t4, t4_old, its

    sr_us = {}
    for kind, N, mode, nm, b, res in s1:
        if kind == "auto" or nm != "ones":
            continue
        a = stencils[N]
        n = a.shape[0]
        nx, ny, nz, taps, coeffs = stencil_taps(a)
        g = k4.make_sr_geometry(nx, ny, nz, taps, mode=mode)
        sr_us[N] = k4_turns(
            f"{N}^3", a, g, b, dict(coeffs=coeffs, tol=TOL, maxiter=n),
            k3.FusedCG(nx, ny, nz, taps, coeffs=coeffs),
            lambda a=a, b=b, n=n: fused_stencil_cg(a, b, tol=TOL, maxiter=n),
            lambda a=a, b=b: cgx_torch.auto_solve(
                a, b, tol=TOL, backend="resident_stencil"))
    dia_us = {}
    dia_cases = [("DIA-7 160^3", m_, None) for m_ in ("rpq", "rp", "p")]
    dia_cases += [("DIA-27 128^3", "rpq", None), ("DIA-27 128^3", "rpq", bf16)]
    for label, mode, pdt in dia_cases:
        a, m = s2_ops[label], jac[label]
        n = a.shape[0]
        b = rhs(n, "ones")
        t_prep = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prep = fdia.dia_prep(a, torch.float32, inv_diag=m.inv_diag)
            torch.cuda.synchronize()
            t_prep.append(time.perf_counter() - t0)
        nx, ny, nz, taps, coeffs, planes, e, w, sym = prep
        t_prep = statistics.median(t_prep) * 1e3
        print(f"[{card}] S5 {label}: one dia_prep {t_prep:.2f} ms (host "
              f"clock, synchronised, median of 3), outside the times below")
        g = k4.make_sr_geometry(nx, ny, nz, taps, mode=mode,
                                n_planes=planes.shape[0], weighted=True,
                                sym=sym)
        eng = k3.FusedCG(nx, ny, nz, taps, coeffs=coeffs, planes=planes,
                         weight=w, sym=sym, plane_dtype=pdt)
        tag = label + (" bf16 planes" if pdt is not None else "")
        b_s = e * b
        k2_planes = planes if pdt is None else planes.to(pdt)
        dia_us[tag, mode] = k4_turns(
            tag, a, g, b_s, dict(coeffs=coeffs, w=w, tol=TOL, maxiter=n,
                                 b_norm_sq=torch.sum(b * b), planes=planes,
                                 plane_dtype=pdt), eng,
            lambda eng=eng, b_s=b_s, n=n: eng.solve(b_s, tol=TOL,
                                                    maxiter=n),
            lambda b_s=b_s, n=n, spec=(nx, ny, nz, taps, coeffs),
            pl=k2_planes, w=w, sym=sym: k2.resident_cg_call(
                spec, b_s, planes=pl, weight=w, sym=sym, tol=TOL,
                maxiter=n))
    b = rhs(n224, "ones")
    its6 = int(next(r.iterations for nm, hist, _, r in s4
                    if nm == "ones" and not hist))
    kw6 = dict(tol=TOL, maxiter=MAXIT_HIST)
    t6, t3, t6_old = time_set([
        lambda: fused_stencil_cg(a224, b, one_pass=True, **kw6),
        lambda: fused_stencil_cg(a224, b, **kw6),
        lambda: k6._before_solve(eng6, b, **kw6)], reps=3)
    # Device time per iteration (profiler; the launches past the exit
    # return at once), the redesign's kernel and the first design's.
    dev_us = {}
    for tag, fn, key in (
            ("K6", lambda: fused_stencil_cg(a224, b, one_pass=True, **kw6),
             "onepass2_kernel"),
            ("first", lambda: k6._before_solve(eng6, b, **kw6),
             "onepass_kernel<")):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev_us[tag] = device_us(prof, lambda kk, key=key: key in kk)
        check(dev_us[tag][0] > 0 and dev_us[tag][1] > 0,
              f"S5: the profiler recorded no device time for {tag}")
    u6, c6 = dev_us["K6"]
    dev6 = u6 / its6
    dev6_old = dev_us["first"][0] / its6
    st6 = eng6.init(b)
    t6p = statistics.median(event_ms(lambda: eng6.kernel_c_reference(
        st6.rz, st6.x, st6.r, st6.p)) for _ in range(3))
    print(f"[{card}] S5 224^3 b=ones: K6 {t6:.3f} ms, "
          f"{t6 / its6 * 1e3:.2f} us/iter ({its6} it); K3 {t3:.3f} ms, "
          f"{t3 / its6 * 1e3:.2f} us/iter; first K6 design {t6_old:.3f} ms, "
          f"{t6_old / its6 * 1e3:.2f} us/iter; K6/K3 {t6 / t3:.3f}, "
          f"K6/first {t6 / t6_old:.3f}; K6 device time {dev6:.2f} us per "
          f"iteration, {u6 / max(c6, 1):.2f} us per launch over {c6} "
          f"launches (profiler; device busy {u6 / (t6 * 1e3):.3f} of the "
          f"solve), first design {dev6_old:.2f} us per iteration; grid "
          f"{grid6}, K3's ga {ga6}, gb {gb6}; plain "
          f"iteration {t6p * 1e3:.2f} us; floors {k6.STREAMS} streams "
          f"{floor_us(k6.STREAMS, n224):.1f} us, {k6.DEVICE_STREAMS} streams "
          f"{floor_us(k6.DEVICE_STREAMS, n224):.1f} us")

    # Bounds: each input read once, each output written once (4 B words);
    # the operations at the fp32 rate.  K4 per solve: b in, x out (planes
    # and w in), per iteration the operator's 2 flops per entry and 12 per
    # row; K6 per launch: x, r, p in and out, two applies.
    n160 = N1 ** 3
    nnz160 = 7 * n160 - 6 * N1 * N1
    t4, t4_old, its4 = sr_us[N1]
    b_k4 = bound(8 * n160, its4 * (2 * nnz160 + 12 * n160))
    # The planes redesign at DIA-27 128³ rpq (fp32 planes), the first
    # design at DIA-7 160³ rpq, the instance that runs it: b in, x out,
    # the planes and w in; per iteration 2 flops a tap and 12 a row.
    d27 = s2_ops["DIA-27 128^3"]
    n128 = d27.shape[0]
    n_pl27 = fdia.dia_prep(d27, torch.float32, inv_diag=jac[
        "DIA-27 128^3"].inv_diag)[5].shape[0]
    t4p, t4p_old, its4p = dia_us["DIA-27 128^3", "rpq"]
    b_k4p = bound((n_pl27 + 3) * 4 * n128, its4p * n128 * (2 * 27 + 12))
    t4f, _, its4f = dia_us["DIA-7 160^3", "rpq"]
    n_pl = fdia.dia_prep(d7, torch.float32,
                         inv_diag=jac["DIA-7 160^3"].inv_diag)[5].shape[0]
    b_k4f = bound((n_pl + 3) * 4 * n160, its4f * n160 * (2 * 7 + 12))
    nnz224 = 7 * n224 - 6 * N224[0] * N224[1]
    b_k6 = bound(k6.STREAMS * 4 * n224, 2 * 2 * nnz224 + 12 * n224)
    print(f"S5 bounds: K4 160^3 {b_k4[0]:.3f} ms ({b_k4[1]}), K4 planes "
          f"DIA-27 128^3 {b_k4p[0]:.3f} ms ({b_k4p[1]}), first K4 design "
          f"DIA-7 160^3 {b_k4f[0]:.3f} ms ({b_k4f[1]}), K6 per launch "
          f"{b_k6[0] * 1e3:.2f} us ({b_k6[1]})")

    def entry(name, source, replaces, nl, err, ms, p_ms, b):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": nl, "max_abs_err": err,
                "ms": ms, "plain_ms": p_ms, "bound_ms": b[0],
                "bound_by": b[1], "library_ms": None}

    src = "cgx_torch/csrc/semiresident.cu"
    return [
        dict(entry("sr_cg", src, "cgx/kernels/fused_semiresident.py:223",
                   launches["sr_cg"], err_k4, t4, plain_ms[N1, "ones"],
                   b_k4), before_ms=t4_old),
        dict(entry("sr_cg_planes", src,
                   "cgx/kernels/fused_semiresident.py:223",
                   launches["sr_cg_planes"], err_k4p["sr2_kernel"], t4p,
                   plain_ms["DIA-27 128^3", "ones"], b_k4p),
             before_ms=t4p_old, cell="DIA-27 128^3 rpq"),
        dict(entry("sr_cg_first", src,
                   "cgx/kernels/fused_semiresident.py:223",
                   launches["sr_cg_first"], err_k4p["sr_kernel"], t4f,
                   plain_ms["DIA-7 160^3", "ones"], b_k4f),
             cell="DIA-7 160^3 rpq"),
        dict(entry("onepass_kernel_c", "cgx_torch/csrc/onepass.cu",
                   "cgx/kernels/fused_onepass.py:53", launches["onepass"],
                   err_k6, dev6 / 1e3, t6p, b_k6),
             first_design_ms=dev6_old / 1e3),
    ]


def k2_times(dev, card, stencils):
    """K2's constant mode at 128³ and 224³ (b = ones) against the
    three-phase kernel it replaced (the same-run "before", counted
    nowhere): bit for bit at one grid, then timed in turns with the plain
    version.  Returns ``({nx: (ms, plain ms, three-phase ms)}, {nx:
    iterations})``."""
    import cgx_torch
    from cgx_torch.kernels import fused_resident as k2
    from cgx_torch.kernels.fused_cg import stencil_taps

    k2_ms, k2_its = {}, {}
    for a in stencils:
        b = torch.ones(a.shape[0], dtype=torch.float32, device=dev)
        spec = stencil_taps(a)
        n = a.shape[0]
        g = min(k2.resident_grid(spec, dev), k2._three_phase_grid(spec, dev))
        new = k2.resident_cg_call(spec, b, tol=TOL, maxiter=n, grid=g)
        old = k2._three_phase_call(spec, b, tol=TOL, maxiter=n, grid=g)
        same = int(new[3]) == int(old[3]) and all(
            torch.equal(u, v) for u, v in zip(new[:3] + new[4:5],
                                              old[:3] + old[4:5]))
        print(f"K2 {a.nx}^3 b=ones: two-phase equal to three-phase at grid "
              f"{g} (x, r, p, iterations, rz), bit for bit: {same}")
        check(same, f"K2 {a.nx}^3: the two-phase kernel differs from the "
              f"three-phase kernel at one grid")
        its = int(cgx_torch.auto_solve(a, b, tol=TOL).iterations)
        its_ref = int(k2.resident_cg_reference(spec, b, tol=TOL,
                                               maxiter=n)[3])
        its_old = int(k2._three_phase_call(spec, b, tol=TOL, maxiter=n)[3])
        t_k2, t_k2p, t_old = time_set([
            lambda: cgx_torch.auto_solve(a, b, tol=TOL),
            lambda: k2.resident_cg_reference(spec, b, tol=TOL, maxiter=n),
            lambda: k2._three_phase_call(spec, b, tol=TOL, maxiter=n)],
            reps=5)
        k2_ms[a.nx] = (t_k2, t_k2p, t_old)
        k2_its[a.nx] = its
        u_new, u_old = t_k2 / its * 1e3, t_old / its_old * 1e3
        s2, s3 = (k2.iteration_streams(three_phase=tp) for tp in (False,
                                                                   True))
        print(f"[{card}] K2 {a.nx}^3 b=ones: {t_k2:.3f} ms/solve, "
              f"{u_new:.2f} us/iter ({its} it); three-phase {t_old:.3f} "
              f"ms/solve, {u_old:.2f} us/iter ({its_old} it); ratio "
              f"{u_new / u_old:.3f}; floors {s2} streams "
              f"{floor_us(s2, n):.1f} us/iter (8 with q recomputed: "
              f"{floor_us(8, n):.1f}), {s3} streams {floor_us(s3, n):.1f}; "
              f"plain {t_k2p:.3f} ms/solve, "
              f"{t_k2p / its_ref * 1e3:.2f} us/iter ({its_ref} it)")
    return k2_ms, k2_its


def k2_plane_times(dev, card, dias):
    """K2's planes mode in fp32 and bf16 planes on ``dias`` (DIA-7 192³,
    DIA-27 128³; b = ones, Jacobi) against the three-phase kernel: bit for
    bit at one grid, then timed in turns with the plain version.  Returns
    ``{label: (ms, plain ms, planes, taps, iterations, three-phase ms)}``
    of the fp32 planes."""
    import cgx_torch
    from cgx_torch.kernels import fused_dia_cg as fdia
    from cgx_torch.kernels import fused_resident as k2

    k2p_ms = {}
    for label, a in dias.items():
        m = cgx_torch.JacobiPrecond.from_matrix(a)
        b = torch.ones(a.shape[0], dtype=torch.float32, device=dev)
        nx, ny, nz, taps, coeffs, planes, e, w, sym = fdia.dia_prep(
            a, torch.float32, inv_diag=m.inv_diag)
        spec, b_s = (nx, ny, nz, taps, coeffs), e * b
        n = a.shape[0]
        fns, its = [], {}
        for pl in (planes, planes.to(torch.bfloat16)):
            # DIA-7's bf16-rounded operator is indefinite and the solve
            # breaks down (X3): 100 iterations there.
            indefinite = pl.dtype == torch.bfloat16 and label.startswith(
                "DIA-7")
            kw = dict(planes=pl, weight=w, sym=sym, tol=TOL,
                      maxiter=100 if indefinite else n)
            g = min(k2.resident_grid(spec, dev, planes=pl, weight=w, sym=sym),
                    k2._three_phase_grid(spec, dev, planes=pl, weight=w,
                                         sym=sym))
            new = k2.resident_cg_call(spec, b_s, grid=g, **kw)
            old = k2._three_phase_call(spec, b_s, grid=g, **kw)
            same = int(new[3]) == int(old[3]) and all(
                torch.equal(u, v) for u, v in zip(new[:3] + new[4:5],
                                                  old[:3] + old[4:5]))
            tag = "bf16" if pl.dtype == torch.bfloat16 else "fp32"
            print(f"K2 planes {label} {tag} b=ones: two-phase equal to "
                  f"three-phase at grid {g}, bit for bit: {same}")
            check(same, f"K2 planes {label} {tag}: the two-phase kernel "
                  f"differs from the three-phase kernel at one grid")
            its[tag] = int(k2.resident_cg_call(spec, b_s, **kw)[3])
            its[tag + " old"] = int(k2._three_phase_call(spec, b_s, **kw)[3])
            fns += [(lambda kw=kw: k2.resident_cg_call(spec, b_s, **kw)),
                    (lambda kw=kw: k2._three_phase_call(spec, b_s, **kw))]
        kw = dict(planes=planes, weight=w, sym=sym, tol=TOL, maxiter=n)
        its_ref = int(k2.resident_cg_reference(spec, b_s, **kw)[3])
        t_k, t_old, t_k16, t_old16, t_p = time_set(
            fns + [lambda: k2.resident_cg_reference(spec, b_s, **kw)],
            reps=3)
        k2p_ms[label] = (t_k, t_p, planes.shape[0], len(taps), its["fp32"],
                         t_old)
        n_pl = planes.shape[0]
        for tag, t_n, t_o, width in (("fp32", t_k, t_old, 1),
                                     ("bf16", t_k16, t_old16, 0.5)):
            u_n = t_n / its[tag] * 1e3
            u_o = t_o / its[tag + " old"] * 1e3
            s_n = k2.iteration_streams(n_pl * width, w is not None)
            s_o = k2.iteration_streams(n_pl * width, w is not None, True)
            print(f"[{card}] K2 planes {label} {tag} b=ones: {t_n:.3f} "
                  f"ms/solve, {u_n:.2f} us/iter ({its[tag]} it, {len(taps)} "
                  f"taps, {n_pl} planes, sym {sym}); three-phase {t_o:.3f} "
                  f"ms/solve, {u_o:.2f} us/iter ({its[tag + ' old']} it); "
                  f"ratio {u_n / u_o:.3f}; floors {s_n:g} streams "
                  f"{floor_us(s_n, n):.1f} us/iter, {s_o:g} streams "
                  f"{floor_us(s_o, n):.1f}")
        print(f"[{card}] K2 planes {label} plain: {t_p:.3f} ms/solve, "
              f"{t_p / its_ref * 1e3:.2f} us/iter ({its_ref} it)")
    return k2p_ms


SOLVER_MAXIT = 5000       # maxiter of SR's solves and the IC PCG solves
# The pipelined solves SR prints, not fails, when they end on the
# stagnation guard: the periodic form past κ ≈ 4·10³ (cgx/solve/cg.py's
# docstring), and the adaptive form at b = ones, where cgx's own adaptive
# form ends on the guard too (fp32 3-D Poisson from 48³ up on the CPU).
GUARD_EXITS = {("pipelined_periodic", "ones"),
               ("pipelined_periodic", "random"),
               ("pipelined_adaptive", "ones")}
CHEB_MAXIT = 20000        # maxiter of CH's Chebyshev solves at 128³
# maxiter of CH's DIA-7 192³ solves, about 4x Jacobi-PCG's 509-540: with
# estimate_bounds' λ_min above the spectrum's bottom (30 power steps on
# λ_max·I − A cannot resolve its cluster) Chebyshev stalls, and 20,000
# steps took 15.6 s there (H100 80GB HBM3, 700 W).
CHEB_DIA_MAXIT = 2000


def solver_phases(dev, card, dias, fp64_solution):
    """N, SR, CH and IC: the rest of the solver family on the card.

    N builds the port's native library into a fresh directory (its build
    time) and parses a seeded legacy file with it, against the numpy parse
    and the writer's input.  SR runs ``cg_solve_single_reduction``,
    ``cg_solve_pipelined(adaptive_replace=True)`` and the periodic
    ``cg_solve_pipelined()`` beside ``cg_solve`` on the 128³ stencil (b =
    ones and seeded), K1's launches of each against what its recurrences
    imply.  CH runs ``chebyshev_solve`` with ``analytic_bounds`` at 128³
    and with ``estimate_bounds`` (a generator seeded 0) under Jacobi on
    DIA-7 192³.  IC builds ``IC0Precond`` (natural, multicolor) and
    ``IC0SweepPrecond(nsweeps=3)`` on ``poisson3d`` 128³ (CSR, fp32), each
    apply against the same function on a CPU copy, and runs their PCG
    beside Jacobi-PCG.  Returns K1's launches in SR and CH."""
    import cgx_torch
    from cgx_torch import native
    from cgx_torch.io.legacy import parse_numpy, read_legacy, write_legacy
    from cgx_torch.io.poisson import poisson2d, poisson3d
    from cgx_torch.kernels import stencil as k1
    from cgx_torch.solve import cg as tcg
    from cgx_torch.solve import chebyshev as tcheb
    from cgx_torch.solve.ic0 import IC0Precond, IC0SweepPrecond

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    launches = {}

    # -- N. the native library --------------------------------------------
    t_phase = time.perf_counter()
    so, secs = native.build(os.path.join(out_dir, f"native_{os.getpid()}"))
    check(secs > 0, "N: the native library was not built afresh")
    native.build()
    print(f"N native library {so.name}: built in {secs:.2f} s (g++ "
          f"{' '.join(native.GXX_FLAGS)})")
    a_l = poisson2d(*LEGACY_2D, device="cpu")
    b_l = np.random.default_rng(SEED + 17).standard_normal(a_l.shape[0])
    path = os.path.join(out_dir, "legacy_seeded_poisson2d_256.txt")
    write_legacy(path, a_l, torch.from_numpy(b_l))
    t0 = time.perf_counter()
    parsed = native.parse_legacy(path)
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = parse_numpy(path)
    t_np = time.perf_counter() - t0
    want = (a_l.col_indices.numpy(), a_l.indptr.numpy(), a_l.values.numpy(),
            b_l)
    same_np = all(np.array_equal(g, w) for g, w in zip(parsed, plain))
    same_in = all(np.array_equal(g, w) for g, w in zip(parsed, want))
    ra, rb = read_legacy(path, device=dev)
    same_dev = (torch.equal(ra.values.cpu(), a_l.values)
                and torch.equal(rb.cpu(), torch.from_numpy(b_l)))
    print(f"N legacy file ({os.path.getsize(path)} bytes, seed "
          f"{SEED + 17}): native parse {t_nat * 1e3:.1f} ms, numpy parse "
          f"{t_np * 1e3:.1f} ms; equal to the numpy parse: {same_np}, to "
          f"the writer's input: {same_in}, read_legacy on the card: "
          f"{same_dev}")
    check(same_np and same_in and same_dev,
          "N: the native parse differs from the numpy parse or the input")
    print(f"N: {time.perf_counter() - t_phase:.1f} s")

    # -- SR. single-reduction and pipelined CG -------------------------------
    t_phase = time.perf_counter()
    a = cgx_torch.poisson3d_stencil(*N128)
    n = a.shape[0]
    rhs = {"ones": torch.ones(n, dtype=torch.float32, device=dev),
           "random": seeded_rhs(n, dev)}
    x64 = {nm: cgx_torch.cg_solve(a.matvec, b.double(), tol=1e-10,
                                  maxiter=SOLVER_MAXIT).x
           for nm, b in rhs.items()}
    solvers = {
        "cg_solve": lambda b: cgx_torch.cg_solve(
            a, b, tol=TOL, maxiter=SOLVER_MAXIT),
        "single_reduction": lambda b: cgx_torch.cg_solve_single_reduction(
            a, b, tol=TOL, maxiter=SOLVER_MAXIT),
        "pipelined_adaptive": lambda b: cgx_torch.cg_solve_pipelined(
            a, b, tol=TOL, maxiter=SOLVER_MAXIT, adaptive_replace=True),
        "pipelined_periodic": lambda b: cgx_torch.cg_solve_pipelined(
            a, b, tol=TOL, maxiter=SOLVER_MAXIT),
    }
    k1.stencil3d_spmv_launches = 0
    runs = {}
    for nm, b in rhs.items():
        for label, solve in solvers.items():
            before = k1.stencil3d_spmv_launches
            tcg.host_reads = tcg.replacements = tcg.discarded_steps = 0
            res = solve(b)
            torch.cuda.synchronize()
            its = int(res.iterations)
            got = k1.stencil3d_spmv_launches - before
            # The recurrences' matvecs: cg_solve one an iteration from
            # x0 = 0; single-reduction one more at the start (w0 = A u0);
            # pipelined the same plus four a replacement (A x, A u, A p,
            # A q) and one a discarded step.
            want = its if label == "cg_solve" else its + 1
            if label.startswith("pipelined"):
                want += 4 * tcg.replacements + tcg.discarded_steps
            runs[nm, label] = (res, its, got, tcg.host_reads,
                               tcg.replacements, tcg.discarded_steps)
            check(got == want, f"SR {label} b={nm}: K1 launched {got} "
                  f"times, the recurrences imply {want}")
            if label != "cg_solve":
                check(tcg.host_reads == its + 1 + tcg.discarded_steps,
                      f"SR {label} b={nm}: {tcg.host_reads} host reads "
                      f"for {its} iterations")
    launches["SR"] = k1.stencil3d_spmv_launches
    for nm, b in rhs.items():
        ms = dict(zip(solvers, time_set([lambda f=f: f(b) for f in
                                         solvers.values()], reps=3)))
        its_cg = runs[nm, "cg_solve"][1]
        for label in solvers:
            res, its, got, reads, reps_, disc = runs[nm, label]
            conv = bool(res.converged)
            fwd = rel(res.x, x64[nm])
            if label == "cg_solve":
                reads = its + 1              # its exit test, uncounted
            print(f"[{card}] SR 128^3 b={nm} {label}: {its} iterations "
                  f"(cg_solve {its_cg}), converged {conv}, true relres "
                  f"(fp64) {true_relres(a, b, res.x):.3e}, |x-x64|/|x64| "
                  f"{fwd:.3e}, {ms[label]:.3f} ms/solve, "
                  f"{ms[label] / max(its, 1) * 1e3:.2f} us/iter; K1 "
                  f"{got} launches, host reads {reads}, replacements "
                  f"{reps_}, discarded steps {disc}")
            if conv:
                check(fwd <= 1e-4, f"SR {label} b={nm}: forward error "
                      f"{fwd}")
            elif (label, nm) in GUARD_EXITS:
                print(f"SR {label} b={nm}: ended on the stagnation guard "
                      f"(converged=False), as the JAX package's form does "
                      f"past its fp32 envelope")
            else:
                fail(f"SR {label} b={nm} did not converge")
    print(f"SR: K1 {launches['SR']} launches; "
          f"{time.perf_counter() - t_phase:.1f} s")

    # -- CH. Chebyshev ---------------------------------------------------------
    t_phase = time.perf_counter()
    lo, hi = cgx_torch.analytic_bounds(a)
    span = 6.0 * float(np.cos(np.pi / (N128[0] + 1)))
    print(f"CH analytic_bounds 128^3: ({lo!r}, {hi!r}); closed form "
          f"6 -/+ 6 cos(pi/129) = ({6.0 - span:.17g}, {6.0 + span:.17g})")
    check(abs(lo - (6.0 - span)) <= 1e-12 and abs(hi - (6.0 + span))
          <= 1e-12, "CH: analytic_bounds differ from the closed form")
    a7 = dias["DIA-7 192^3"]
    m7 = cgx_torch.JacobiPrecond.from_matrix(a7)
    n7 = a7.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    lo7, hi7 = cgx_torch.estimate_bounds(
        lambda v: m7.apply(cgx_torch.spmv(a7, v)), n7, key=gen, device=dev)
    lo7, hi7 = float(lo7), float(hi7)
    t_est = time.perf_counter() - t0
    print(f"CH estimate_bounds DIA-7 192^3 under Jacobi (30 + 30 power "
          f"steps, generator seeded 0): ({lo7:.6e}, {hi7:.6e}) in "
          f"{t_est:.2f} s")
    # The same estimate where the spectrum is known: the 128³ stencil.
    gen.manual_seed(0)
    lo_e, hi_e = (float(v) for v in cgx_torch.estimate_bounds(
        a, n, key=gen, device=dev))
    print(f"CH estimate_bounds 128^3 stencil (generator seeded 0): "
          f"({lo_e:.6e}, {hi_e:.6e}) against the analytic ({lo:.6e}, "
          f"{hi:.6e}): lambda_min {lo_e / lo:.1f}x the true one, "
          f"lambda_max {hi_e / hi:.4f}x")
    check(hi_e >= hi, "CH: estimate_bounds' lambda_max is below the "
          "spectrum's top")
    cases = [("128^3", nm, a, None, lo, hi, b, x64[nm],
              runs[nm, "cg_solve"][1], CHEB_MAXIT) for nm, b in rhs.items()]
    for nm in ("ones", "random"):
        b = (torch.ones(n7, dtype=torch.float32, device=dev) if nm == "ones"
             else seeded_rhs(n7, dev))
        jac = cgx_torch.cg_solve(a7, b, tol=TOL, maxiter=SOLVER_MAXIT,
                                 preconditioner=m7)
        cases.append(("DIA-7 192^3", nm, a7, m7, lo7, hi7, b,
                      fp64_solution("DIA-7 192^3", nm, a7, b),
                      int(jac.iterations), CHEB_DIA_MAXIT))
    k1.stencil3d_spmv_launches = 0
    for label, nm, op, m, lmin, lmax, b, xref, its_cg, maxit in cases:
        before = k1.stencil3d_spmv_launches
        tcheb.host_reads = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = cgx_torch.chebyshev_solve(op, b, lmin, lmax, tol=TOL,
                                        maxiter=maxit, preconditioner=m)
        end.record()
        end.synchronize()
        its, reads = int(res.iterations), tcheb.host_reads
        got = k1.stencil3d_spmv_launches - before
        want = its if m is None else 0      # DIA products are plain torch
        check(got == want, f"CH {label} b={nm}: K1 launched {got} times, "
              f"the recurrence implies {want}")
        check(reads == 1 + its // 16, f"CH {label} b={nm}: {reads} host "
              f"reads for {its} iterations")
        ms = start.elapsed_time(end)
        if m is None:        # the 128³ solves again, in three repetitions
            ms = statistics.median(event_ms(
                lambda: cgx_torch.chebyshev_solve(
                    op, b, lmin, lmax, tol=TOL, maxiter=maxit))
                for _ in range(3))
        conv = bool(res.converged)
        fwd = rel(res.x, xref)
        relres = (true_relres(op, b, res.x) if m is None else rel(
            cgx_torch.spmv(op.astype(torch.float64), res.x.double()),
            b.double()))
        print(f"[{card}] CH {label} b={nm}: {its} iterations "
              f"({'cg_solve' if m is None else 'Jacobi-PCG'} {its_cg}), "
              f"converged {conv}, true relres (fp64) {relres:.3e}, "
              f"|x-x64|/|x64| {fwd:.3e}, {ms:.3f} ms/solve, "
              f"{ms / its * 1e3:.2f} us/iter, host reads {reads}, K1 "
              f"{got} launches")
        if m is None:
            check(conv, f"CH {label} b={nm} did not converge")
            check(fwd <= 1e-4, f"CH {label} b={nm}: forward error {fwd}")
        elif conv:
            check(fwd <= 1e-4, f"CH {label} b={nm}: forward error {fwd}")
        else:
            print(f"CH {label} b={nm}: not converged in {maxit} "
                  f"iterations: estimate_bounds' lambda_min is above the "
                  f"spectrum's bottom (see the 128^3 estimate)")
    launches["CH"] = k1.stencil3d_spmv_launches
    print(f"CH: K1 {launches['CH']} launches; "
          f"{time.perf_counter() - t_phase:.1f} s")

    # -- IC. IC(0) -------------------------------------------------------------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    acsr = poisson3d(*N128, dtype=np.float32, device=dev)
    print(f"IC poisson3d 128^3 CSR ({acsr.nnz} nonzeros) built in "
          f"{time.perf_counter() - t0:.2f} s")
    v = seeded_rhs(n, dev)
    check(maxrel(cgx_torch.spmv(acsr, v), a.matvec(v)) <= 1e-6,
          "IC: poisson3d's CSR is not the 128^3 stencil's matrix")
    b = rhs["ones"]
    builders = {
        "natural": lambda tm: IC0Precond.from_matrix(acsr, timings=tm),
        "multicolor": lambda tm: IC0Precond.from_matrix(
            acsr, ordering="multicolor", timings=tm),
        "sweep nsweeps=3": lambda tm: IC0SweepPrecond.from_matrix(
            acsr, nsweeps=3),
    }
    jac = cgx_torch.JacobiPrecond.from_matrix(acsr)
    pcg = {}
    for label, build in builders.items():
        tm = {}
        t0 = time.perf_counter()
        m = build(tm)
        t_setup = time.perf_counter() - t0
        if isinstance(m, IC0Precond):
            shape = (f"levels {m.n_levels} (backward "
                     f"{len(m.b_levels.counts)}), widest "
                     f"{max(m.f_levels.counts)} rows, row_nnz "
                     f"{m.f_cols.shape[2]}, padded gathers per apply "
                     f"{m.padded_gathers}")
            m_cpu = IC0Precond(**{f: getattr(m, f).cpu() for f in (
                "f_rows", "f_cols", "f_vals", "f_inv_diag", "b_rows",
                "b_cols", "b_vals", "b_inv_diag")}, n=m.n,
                n_levels=m.n_levels, perm=None if m.perm is None
                else tuple(p.cpu() for p in m.perm))
        else:
            shape = (f"levels {m.n_levels}, {2 * m.nsweeps} DIA "
                     f"products of {len(m.lower.offsets)} diagonals, no "
                     f"gathers")
            m_cpu = IC0SweepPrecond(lower=m.lower.to("cpu"),
                                    upper=m.upper.to("cpu"),
                                    inv_diag=m.inv_diag.cpu(),
                                    nsweeps=m.nsweeps, n_levels=m.n_levels)
        z = m.apply(v)
        z_cpu = m_cpu.apply(v.cpu())
        d_apply = rel(z.cpu(), z_cpu)
        ms_apply = statistics.median(event_ms(lambda: m.apply(v))
                                     for _ in range(3))
        dev_apply = device_ms(lambda: m.apply(v), calls=3)
        steps = ", ".join(f"{k} {tm[k]:.2f}" for k in (
            "coloring", "permute", "pattern", "factor", "levels", "pack",
            "to_device") if k in tm)
        steps = f" ({steps})" if steps else ""
        print(f"[{card}] IC {label}: setup {t_setup:.2f} s on the host"
              f"{steps}; {shape}; {ms_apply:.3f} ms per apply "
              f"(events), of it {dev_apply:.3f} ms on the device "
              f"(profiler); apply against its CPU copy {d_apply:.3e} "
              f"(bound 1e-5)")
        check(d_apply <= 1e-5, f"IC {label}: the apply differs from its "
              f"CPU copy by {d_apply}")
        pcg[label] = m
    pcg["Jacobi"] = jac
    its = {}
    for label, m in pcg.items():
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = cgx_torch.cg_solve(acsr, b, tol=TOL, maxiter=SOLVER_MAXIT,
                                 preconditioner=m)
        end.record()
        end.synchronize()
        its[label] = int(res.iterations)
        conv = bool(res.converged)
        fwd = rel(res.x, x64["ones"])
        print(f"[{card}] IC PCG 128^3 b=ones, {label}: {its[label]} "
              f"iterations, converged {conv}, |x-x64|/|x64| {fwd:.3e}, "
              f"{start.elapsed_time(end):.1f} ms/solve (one solve, "
              f"events), {start.elapsed_time(end) / its[label] * 1e3:.1f} "
              f"us/iter")
        check(conv, f"IC PCG {label} did not converge")
        check(fwd <= 1e-4, f"IC PCG {label}: forward error {fwd}")
    check(its["natural"] < its["Jacobi"], f"IC: natural IC(0) took "
          f"{its['natural']} iterations, Jacobi-PCG {its['Jacobi']}")
    print(f"IC: {time.perf_counter() - t_phase:.1f} s")
    return launches



EFT_PAIRS = 1 << 20       # HP's seeded pairs for two_prod and two_sum
DF64_CG_MAXIT = 20000     # maxiter of HP's whole-df64 CG
HP_STANDIN = "bcsstk17"   # HP's ill-conditioned stand-in, full scale
CK_CHUNK = 100            # iterations a chunk in CK
CK_MAXIT = 5000           # maxiter of CK's solves (chunked and monolithic)


class Preempted(Exception):
    """Raised from an ``on_chunk`` hook to stop a solve as a preemption
    would."""


def kill_after(chunks: int):
    """An ``on_chunk`` hook that raises after ``chunks`` chunks."""
    seen = []

    def hook(state):
        seen.append(int(state.k))
        if len(seen) == chunks:
            raise Preempted
    return hook


def df_equal(u, v) -> bool:
    """Two df64 arrays equal word for word."""
    return torch.equal(u.hi, v.hi) and torch.equal(u.lo, v.lo)


def accuracy_phases(dev, card, thermal, dias):
    """HP, NF and CK: the accuracy and reliability layer on the card.

    HP holds the df64 error-free transforms against fp64 on the card, the
    df64 ELL product at thermal2 against torch's fp64 CSR product, and
    drives the df64 refinement: WBELL inners (K7) at thermal2, IC(0) and
    Jacobi ELL inners on the bcsstk17 stand-in, the k = 4 multi-RHS
    refinement (K8) at thermal2, and the whole-df64 CG on the bcsstk17
    stand-in.  NF saves and loads the thermal2 operator bundle (the
    prebuilt solver equals the fresh one bit for bit) and round-trips a
    WBELL and a DIA matrix (the bcsstk17 stand-in's, DIA-7 64³).  CK runs the four checkpointed backends
    ("xla" and K2 on the 128³ stencil, K3 on DIA-7 192³ under Jacobi, K4
    in rpq on the 160³ stencil) against their monolithic solves, after a
    preemption, and across backends.  ``thermal``
    is W1's ``(a, op, plan)``.  Returns each phase's launches of the
    kernels it drove, HP's single-card refinement figures at thermal2
    (``HP_figures``: outer cycles, inner iterations, ms) and the path of
    NF's thermal2 bundle, kept for the CLI phase (``NF_bundle``)."""
    import cgx_torch
    from cgx_torch.io import native_format as nf
    from cgx_torch.io.suitesparse import standin
    from cgx_torch.kernels import fused_engine as k3
    from cgx_torch.kernels import fused_resident as k2
    from cgx_torch.kernels import fused_semiresident as k4
    from cgx_torch.kernels import stencil as k1
    from cgx_torch.kernels import wbell as kw
    from cgx_torch.kernels.fused_dia_cg import fused_dia_cg
    from cgx_torch.kernels.fused_cg import stencil_taps
    from cgx_torch.ops import df64 as d64
    from cgx_torch.solve import hp
    from cgx_torch.solve.ic0 import IC0Precond
    from cgx_torch.utils import checkpoint as ckp

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(SEED + 41)
    launches = {}

    def csr64(a):
        """torch's fp64 CSR tensor of a port CSR matrix (the reference
        product)."""
        return torch.sparse_csr_tensor(a.indptr, a.col_indices,
                                       a.values.double(), size=a.shape)

    def product64(a64, x):
        return (a64 @ x[:, None])[:, 0]

    def relres64(a64, b, x):
        """TRUE ‖b − A·x‖/‖b‖ in fp64 on the card (x a df64 pair or an
        fp64/fp32 vector; b a host fp64 array)."""
        b = torch.from_numpy(np.asarray(b, np.float64)).to(dev)
        if isinstance(x, d64.DF64):
            x = x.hi.double() + x.lo.double()
        r = b - product64(a64, x.double())
        return float(torch.linalg.vector_norm(r)
                     / torch.linalg.vector_norm(b))

    def timed(fn):
        """``(fn(), ms)`` by CUDA events around one call."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    # -- HP. the error-free transforms on the card ------------------------
    t_phase = time.perf_counter()

    def pairs():
        mag = rng.uniform(1.0, 2.0, EFT_PAIRS) * np.exp2(
            rng.integers(-12, 13, EFT_PAIRS))
        sign = rng.choice(np.array([-1.0, 1.0]), EFT_PAIRS)
        return torch.from_numpy((sign * mag).astype(np.float32)).to(dev)

    ea, eb = pairs(), pairs()
    p, e = d64.two_prod(ea, eb)
    s, se = d64.two_sum(ea, eb)
    # Exact in fp64: a product of two fp32 has 48 bits, and the sum of two
    # whose exponents differ by at most 25 has at most 50.
    bad_p = int(((p.double() + e.double())
                 != ea.double() * eb.double()).sum())
    bad_s = int(((s.double() + se.double())
                 != ea.double() + eb.double()).sum())
    print(f"HP error-free transforms on the card, {EFT_PAIRS} seeded fp32 "
          f"pairs (seed {SEED + 41}): two_prod {bad_p} mismatches against "
          f"the exact fp64 product, two_sum {bad_s} against the exact sum")
    check(bad_p == 0 and bad_s == 0, f"HP: the transforms are not exact on "
          f"the card ({bad_p} products, {bad_s} sums)")
    del ea, eb, p, e, s, se
    # df_dot without cancellation (2^20 positive pairs), against the dot in
    # extended precision on the host and torch's fp64 dot on the card.
    xs = rng.uniform(0.5, 1.5, EFT_PAIRS)
    ys = rng.uniform(0.5, 1.5, EFT_PAIRS)
    ref = float(np.sum(xs.astype(np.longdouble) * ys.astype(np.longdouble)))
    dd = d64.df_dot(d64.df_from_f64(xs, dev), d64.df_from_f64(ys, dev))
    got = float(dd.hi) + float(dd.lo)
    f64 = float(torch.dot(torch.from_numpy(xs).to(dev),
                          torch.from_numpy(ys).to(dev)))
    rel_df, rel_64 = abs(got - ref) / abs(ref), abs(f64 - ref) / abs(ref)
    print(f"HP df_dot over {EFT_PAIRS} positive pairs: {rel_df:.3e} "
          f"relative to the extended-precision dot (bound 2^-46 = "
          f"{2.0 ** -46:.3e}); torch's fp64 dot {rel_64:.3e}")
    check(rel_df <= 2.0 ** -46, f"HP: df_dot off by {rel_df}")
    # With cancellation (tests/test_hp.py's adversarial case).
    xc = rng.standard_normal(4096) * np.logspace(0, 6, 4096)
    yc = rng.standard_normal(4096)
    ref_c = float(np.sum(xc.astype(np.longdouble) * yc.astype(np.longdouble)))
    dc = d64.df_dot(d64.df_from_f64(xc, dev), d64.df_from_f64(yc, dev))
    rel_c = abs(float(dc.hi) + float(dc.lo) - ref_c) / abs(ref_c)
    rel_c32 = abs(float(torch.dot(
        torch.from_numpy(xc.astype(np.float32)).to(dev),
        torch.from_numpy(yc.astype(np.float32)).to(dev))) - ref_c) / abs(ref_c)
    print(f"HP df_dot with cancellation (4096 pairs): {rel_c:.3e} relative "
          f"(bound 1e-11), fp32 dot {rel_c32:.3e}")
    check(rel_c <= 1e-11 and rel_c <= 1e-3 * rel_c32,
          f"HP: df_dot with cancellation off by {rel_c}")

    # -- HP. df64 SpMV at thermal2 ----------------------------------------
    a_th = thermal[0]
    n_th = a_th.shape[0]
    a64 = csr64(a_th)
    s_th = hp._scipy_f64(a_th)
    t0 = time.perf_counter()
    a_hp = hp.df64_ell_from_csr(s_th, device=dev)
    torch.cuda.synchronize()
    t_ell = time.perf_counter() - t0
    xs = rng.standard_normal(n_th)
    xd = d64.df_from_f64(xs, dev)
    x64 = torch.from_numpy(xs).to(dev)
    y = hp.df64_ell_spmv(a_hp, xd)
    y64 = product64(a64, x64)
    err = float(torch.linalg.vector_norm(y.hi.double() + y.lo.double() - y64)
                / torch.linalg.vector_norm(y64))
    t_df, t_csr = time_pair(lambda: hp.df64_ell_spmv(a_hp, xd),
                            lambda: product64(a64, x64), reps=5)
    print(f"[{card}] HP df64_ell_spmv thermal2 ({n_th} rows, width "
          f"{a_hp.width}, built on the host in {t_ell:.2f} s): "
          f"{err:.3e} relative to torch's fp64 CSR product (bound 1e-13); "
          f"{t_df:.3f} ms against the fp64 CSR product's {t_csr:.3f} ms")
    check(err <= 1e-13, f"HP: df64 SpMV off by {err}")

    # -- HP. the refinement over WBELL inners (K7) at thermal2 -------------
    diag_th = s_th.diagonal()
    m_th = cgx_torch.JacobiPrecond(inv_diag=torch.from_numpy(
        (1.0 / diag_th).astype(np.float32)).to(dev))
    t0 = time.perf_counter()
    solve_th = cgx_torch.make_ir_df64_solver(
        a_th, tol=TOL, inner_format="wbell", preconditioner=m_th,
        device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    b1 = rng.standard_normal(n_th)
    b2 = rng.standard_normal(n_th)
    kw.wbell_resident_launches = 0
    (res1, info1), ms1 = timed(lambda: solve_th(b1))
    k7_ir = kw.wbell_resident_launches
    (res2, info2), ms2 = timed(lambda: solve_th(b2))
    launches["HP_k7"] = kw.wbell_resident_launches
    rel1, rel2 = relres64(a64, b1, res1.x), relres64(a64, b2, res2.x)
    for nm, info, rel_, ms in (("b1", info1, rel1, ms1),
                               ("b2", info2, rel2, ms2)):
        print(f"[{card}] HP IR-df64 thermal2 WBELL+Jacobi {nm}: "
              f"{info['outer']} outer cycles, {info['inner_iterations']} "
              f"inner iterations, true relres (fp64) {rel_:.3e} (the "
              f"loop's {info['relres']:.3e}), {ms:.1f} ms per right-hand "
              f"side")
        check(rel_ <= 1.5e-6, f"HP thermal2 {nm}: true relres {rel_}")
        launches.setdefault("HP_figures", {})[nm] = (
            info["outer"], info["inner_iterations"], ms)
    print(f"HP IR-df64 thermal2: operator build (df64 ELL + WBELL) "
          f"{t_build:.2f} s on the host; K7 {k7_ir} launches in the first "
          f"solve, {launches['HP_k7']} in both")
    check(k7_ir > 0, "HP: the WBELL refinement did not launch K7")

    # -- HP. the bcsstk17 stand-in: IC(0) and Jacobi ELL inners -------------
    t0 = time.perf_counter()
    a_b = standin(HP_STANDIN, seed=SEED, device=dev)
    s_b = hp._scipy_f64(a_b)
    n_b = s_b.shape[0]
    a_b64 = csr64(a_b)
    a32 = cgx_torch.csr_from_scipy(s_b.astype(np.float32), device=dev)
    ic = IC0Precond.from_matrix(a32)
    m_b = cgx_torch.JacobiPrecond(inv_diag=torch.from_numpy(
        (1.0 / s_b.diagonal()).astype(np.float32)).to(dev))
    print(f"HP {HP_STANDIN} stand-in: {n_b} rows, {s_b.nnz} nonzeros; "
          f"stand-in and IC(0) ({ic.n_levels} levels) in "
          f"{time.perf_counter() - t0:.2f} s")
    bb = rng.standard_normal(n_b)
    for label, m in (("IC(0)", ic), ("Jacobi", m_b)):
        (res, info), ms = timed(lambda: cgx_torch.ir_df64_solve(
            s_b, bb, tol=TOL, inner_maxiter=5000, preconditioner=m,
            inner_format="ell", device=dev))
        rel_ = relres64(a_b64, bb, res.x)
        print(f"[{card}] HP IR-df64 {HP_STANDIN} ELL+{label}: "
              f"{info['outer']} outer, {info['inner_iterations']} inner "
              f"iterations, true relres (fp64) {rel_:.3e}, {ms:.1f} ms "
              f"(operator builds included)")
        check(rel_ <= 1.5e-6, f"HP {HP_STANDIN} {label}: true relres "
              f"{rel_}")
    r32 = cgx_torch.cg_solve(a32, torch.from_numpy(bb.astype(np.float32))
                             .to(dev), tol=TOL, maxiter=DF64_CG_MAXIT,
                             preconditioner=m_b)
    print(f"HP fp32 Jacobi-PCG {HP_STANDIN}: {int(r32.iterations)} "
          f"iterations, converged {bool(r32.converged)}, true relres "
          f"(fp64) {relres64(a_b64, bb, r32.x):.3e}")

    # -- HP. whole-df64 CG on the bcsstk17 stand-in --------------------------
    a_b_hp = hp.df64_ell_from_csr(s_b, device=dev)
    t0 = time.perf_counter()
    res, ms = timed(lambda: hp.df64_cg_solve(
        a_b_hp, bb, tol=TOL, maxiter=DF64_CG_MAXIT, jacobi=True))
    its, conv = int(res.iterations), bool(res.converged)
    rel_ = relres64(a_b64, bb, res.x)
    print(f"[{card}] HP df64_cg_solve(jacobi=True) {HP_STANDIN}: {its} "
          f"iterations (cap {DF64_CG_MAXIT}), converged {conv}, true "
          f"relres (fp64) {rel_:.3e}, {ms / 1e3:.2f} s "
          f"({ms / max(its, 1):.3f} ms/iter)")
    if conv:
        check(rel_ <= 1.5 * TOL, f"HP df64 CG: converged with true relres "
              f"{rel_}")
    print(f"HP: {time.perf_counter() - t_phase:.1f} s")

    # -- NF. the operator bundle and matrix files ---------------------------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    op = hp.IRDF64Operator(a_hp=a_hp, wb=cgx_torch.wbell_from_csr(
        s_th, device=dev), diag=diag_th)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    path = os.path.join(out_dir, f"thermal2_ir_df64_{os.getpid()}.npz")
    t0 = time.perf_counter()
    nf.save_df64_operator(path, op)
    t_save = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    op2, _ = nf.load_df64_operator(path, device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    launches["NF_bundle"] = path          # kept for the CLI phase
    del op
    kw.wbell_resident_launches = 0
    res_p, info_p = cgx_torch.make_ir_df64_solver(
        prebuilt=op2, tol=TOL, preconditioner=m_th)(b1)
    k7_nf = kw.wbell_resident_launches
    same = df_equal(res_p.x, res1.x) and info_p == info1
    print(f"[{card}] NF thermal2 bundle: {size / 1e6:.1f} MB, saved in "
          f"{t_save:.2f} s, loaded in {t_load:.2f} s (the WBELL build for "
          f"it {t_op:.2f} s); the prebuilt solver's x equals the freshly "
          f"built one's bit for bit: {same} ({info_p['outer']} outer, "
          f"{info_p['inner_iterations']} inner, K7 {k7_nf} launches)")
    check(same, "NF: the prebuilt solver differs from the fresh one")
    x_b = torch.from_numpy(rng.standard_normal(n_b).astype(np.float32)).to(
        dev)
    d64_7 = scaled_dia7(N64, dev)
    x_7 = seeded_rhs(d64_7.shape[0], dev)
    wb_b = cgx_torch.wbell_from_csr(s_b, device=dev)
    for label, m, x, fields, product in (
            (f"WBELL {HP_STANDIN}", wb_b, x_b, nf._WBELL_FIELDS,
             lambda w, v: kw.wbell_spmv(w, w.to_internal(v))),
            ("DIA-7 64^3", d64_7, x_7, ("data",), cgx_torch.spmv)):
        p_m = os.path.join(out_dir, f"nf_{os.getpid()}.npz")
        t0 = time.perf_counter()
        nf.save_matrix(p_m, m)
        t_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        m2, _ = nf.load_matrix(p_m, device=dev)
        t_l = time.perf_counter() - t0
        size_m = os.path.getsize(p_m)
        os.remove(p_m)
        same = all(torch.equal(getattr(m2, f), getattr(m, f))
                   for f in fields) and m2.shape == m.shape
        same_y = torch.equal(product(m2, x), product(m, x))
        print(f"NF {label}: {size_m / 1e6:.1f} MB, saved in {t_s:.2f} s, "
              f"loaded in {t_l:.2f} s; every array equal: {same}; its "
              f"product equal bit for bit: {same_y}")
        check(same and same_y, f"NF: {label} does not round-trip")
    print(f"NF: {time.perf_counter() - t_phase:.1f} s")

    # -- HP. multi-RHS refinement (K8) at thermal2, on the loaded bundle --
    t_phase = time.perf_counter()
    bk = rng.standard_normal((n_th, K_MULTI))
    kw.wbell_tiered_launches = 0
    kw.wbell_resident_launches = 0
    t0 = time.perf_counter()
    solve_k = cgx_torch.make_ir_df64_solver_multi(prebuilt=op2, tol=TOL)
    t_plan = time.perf_counter() - t0
    (res_k, info_k), ms_k = timed(lambda: solve_k(bk))
    launches["HP_k8"] = kw.wbell_tiered_launches
    rels = [relres64(a64, bk[:, j], d64.DF64(res_k.x.hi[:, j],
                                              res_k.x.lo[:, j]))
            for j in range(K_MULTI)]
    print(f"[{card}] HP IR-df64 multi thermal2 k={K_MULTI} (Jacobi, tier "
          f"plan in {t_plan:.2f} s): {info_k['outer']} outer, "
          f"{info_k['inner_iterations']} inner iterations, true relres "
          f"(fp64) per column {[f'{r:.3e}' for r in rels]}, {ms_k:.1f} ms "
          f"({ms_k / K_MULTI:.1f} per column); K8 {launches['HP_k8']} "
          f"launches, K7 {kw.wbell_resident_launches}")
    check(all(r <= 1.5e-6 for r in rels), f"HP multi: true relres {rels}")
    check(launches["HP_k8"] > 0, "HP multi: K8 was not launched")
    launches["HP_figures"][f"k={K_MULTI}"] = (
        info_k["outer"], info_k["inner_iterations"], ms_k)
    del op2, solve_k, solve_th, a_hp, a64
    print(f"HP multi: {time.perf_counter() - t_phase:.1f} s")

    # -- CK. the checkpointed backends ---------------------------------------
    from cgx_torch.kernels.fused_resident import resident_stencil_cg
    from cgx_torch.kernels.fused_semiresident import sr_stencil_cg

    t_phase = time.perf_counter()
    a128 = cgx_torch.poisson3d_stencil(*N128)
    a160 = cgx_torch.poisson3d_stencil(*N160)
    a7 = dias["DIA-7 192^3"]
    m7 = cgx_torch.JacobiPrecond.from_matrix(a7)
    b128, b160 = seeded_rhs(a128.shape[0], dev), seeded_rhs(a160.shape[0],
                                                            dev)
    b7 = seeded_rhs(a7.shape[0], dev)
    nx, ny, nz, taps, _ = stencil_taps(a160)
    tier = k4.sr_mode(nx, ny, nz, taps)
    check(tier == "rpq", f"CK: K4's tier at 160^3 is {tier}")
    counters = {"xla": (k1, "stencil3d_spmv_launches"),
                "resident": (k2, "resident_cg_launches"),
                "fused": (k3, "fused_a_launches"),
                "sr": (k4, "sr_cg_launches")}
    cells = [
        ("xla", "128^3 stencil", a128, None, b128,
         lambda: cgx_torch.cg_solve(a128, b128, tol=TOL, maxiter=CK_MAXIT)),
        ("resident", "128^3 stencil", a128, None, b128,
         lambda: resident_stencil_cg(a128, b128, tol=TOL,
                                     maxiter=CK_MAXIT)),
        ("fused", "DIA-7 192^3 Jacobi", a7, m7, b7,
         lambda: fused_dia_cg(a7, b7, tol=TOL, maxiter=CK_MAXIT,
                              inv_diag=m7.inv_diag)),
        ("sr", "160^3 stencil rpq", a160, None, b160,
         lambda: sr_stencil_cg(a160, b160, tol=TOL, maxiter=CK_MAXIT)),
    ]
    for backend, label, a, m, b, mono in cells:
        solver = ckp.make_checkpointed_solver(
            a, tol=TOL, maxiter=CK_MAXIT, preconditioner=m, chunk=CK_CHUNK,
            backend=backend)
        mod, attr = counters[backend]
        setattr(mod, attr, 0)
        if backend == "fused":
            k3.fused_b_launches = 0
        res_c = solver(b)
        torch.cuda.synchronize()
        launches[f"CK_{backend}"] = getattr(mod, attr)
        if backend == "fused":
            launches["CK_fused_b"] = k3.fused_b_launches
        res_m = mono()
        its = int(res_c.iterations)
        same = its == int(res_m.iterations) and torch.equal(res_c.x, res_m.x)
        t_c, t_m = time_pair(lambda: solver(b), mono, reps=3)
        print(f"[{card}] CK {backend} ({label}): {its} iterations in "
              f"chunks of {CK_CHUNK}, equal to the monolithic solve bit for "
              f"bit: {same}; chunked {t_c:.2f} ms, monolithic {t_m:.2f} ms "
              f"({t_c / t_m:.3f}x); {attr} {launches[f'CK_{backend}']}")
        check(bool(res_c.converged) and same,
              f"CK {backend}: the chunked solve differs from the monolithic")
        check(launches[f"CK_{backend}"] > 0,
              f"CK {backend}: its kernel was not launched")
        # Preempted after two chunks, relaunched from the file.
        p_ck = os.path.join(out_dir, f"ck_{backend}_{os.getpid()}.npz")
        if os.path.exists(p_ck):
            os.remove(p_ck)
        setattr(mod, attr, 0)
        try:
            solver(b, checkpoint_path=p_ck, on_chunk=kill_after(2))
            fail(f"CK {backend}: the preemption hook did not fire")
        except Preempted:
            pass
        n_pre = getattr(mod, attr)
        k_file = (int(ckp.load_state(p_ck, device=dev).k)
                  if os.path.exists(p_ck) else None)
        check(k_file == 2 * CK_CHUNK, f"CK {backend}: the preempted run's "
              f"file holds k = {k_file}, not {2 * CK_CHUNK}")
        if backend == "fused":
            # One snapshot write, timed apart.
            st = ckp.load_state(p_ck, device=dev)
            t0 = time.perf_counter()
            ckp.save_state(p_ck + ".w.npz", st)
            t_w = time.perf_counter() - t0
            print(f"CK snapshot write ({label}, {a.shape[0]} rows, fp32): "
                  f"{os.path.getsize(p_ck + '.w.npz') / 1e6:.1f} MB in "
                  f"{t_w * 1e3:.1f} ms (host clock, from the card)")
            os.remove(p_ck + ".w.npz")
        seen = []
        setattr(mod, attr, 0)
        res_r = solver(b, checkpoint_path=p_ck,
                       on_chunk=lambda st: seen.append(int(st.k)))
        n_res = getattr(mod, attr)
        os.remove(p_ck)
        d_r = rel(res_r.x, res_c.x)
        bitwise = (int(res_r.iterations) == its
                   and torch.equal(res_r.x, res_c.x))
        print(f"CK {backend}: preempted after 2 chunks ({n_pre} launches; "
              f"its file at k = {k_file}) and resumed from its file: first "
              f"chunk ends at k = {seen[:1]}, {n_res} launches (the "
              f"chunked solve's {launches[f'CK_{backend}']}), "
              f"{int(res_r.iterations)} iterations, equal to the "
              f"uninterrupted solve bit for bit: {bitwise} "
              f"(|dx|/|x| {d_r:.3e})")
        check(seen[:1] == [min(3 * CK_CHUNK, its)], f"CK {backend}: the "
              f"resumed run's first chunk ends at {seen[:1]}, so it did not "
              f"start from the file's k = {2 * CK_CHUNK}")
        check(n_res == launches[f"CK_{backend}"] - n_pre, f"CK {backend}: "
              f"the resumed run launched {n_res} times, not the chunked "
              f"solve's {launches[f'CK_{backend}']} less the preempted "
              f"run's {n_pre}")
        if m is None:
            check(bitwise, f"CK {backend}: the resumed solve differs")
        else:
            # The file holds the unscaled state; e·(x̃/e) may move a bit.
            check(abs(int(res_r.iterations) - its) <= 1 and d_r <= 1e-5,
                  f"CK {backend}: the resumed solve is off by {d_r}")
    # A fused (K3) snapshot resumed under "xla".
    p_x = os.path.join(out_dir, f"ck_cross_{os.getpid()}.npz")
    fused7 = ckp.make_checkpointed_solver(a7, tol=TOL, maxiter=CK_MAXIT,
                                          preconditioner=m7, chunk=CK_CHUNK,
                                          backend="fused")
    try:
        fused7(b7, checkpoint_path=p_x, on_chunk=kill_after(1))
    except Preempted:
        pass
    res_x = ckp.make_checkpointed_solver(
        a7, tol=TOL, maxiter=CK_MAXIT, preconditioner=m7, chunk=CK_CHUNK,
        backend="xla")(b7, checkpoint_path=p_x)
    os.remove(p_x)
    plain = cgx_torch.cg_solve(a7, b7, tol=TOL, maxiter=CK_MAXIT,
                               preconditioner=m7)
    d_x = rel(res_x.x, plain.x)
    print(f"CK a fused snapshot (DIA-7 192^3, after 1 chunk) resumed under "
          f"xla: {int(res_x.iterations)} iterations (cg_solve "
          f"{int(plain.iterations)}), |x-x_plain|/|x_plain| {d_x:.3e} "
          f"(bound 1e-4)")
    check(bool(res_x.converged) and d_x <= 1e-4,
          f"CK: the cross-backend resume is off by {d_x}")
    print(f"CK: {time.perf_counter() - t_phase:.1f} s")
    return launches


def profiling_phase(dev, card) -> int:
    """PF: ``cgx_torch.utils.profiling.trace`` around one K2 solve at 128³;
    ``trace_report`` must name K2's kernel with a device time, printed
    beside the same solve's queued-event time, and ``overlap_report``
    runs.  Returns K2's launches in the traced solve.  Run by
    :func:`profiling_child` in a process of its own."""
    import cgx_torch
    from cgx_torch.kernels import fused_resident as k2
    from cgx_torch.kernels.fused_resident import resident_stencil_cg
    from cgx_torch.utils import profiling as prof

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    a128 = cgx_torch.poisson3d_stencil(*N128)
    b128 = seeded_rhs(a128.shape[0], dev)
    t_phase = time.perf_counter()
    tb_dir = os.path.join(out_dir, f"trace_{os.getpid()}")
    k2.resident_cg_launches = 0
    with prof.trace(tb_dir):
        with prof.annotate("cgx_k2_solve"):
            res = resident_stencil_cg(a128, b128, tol=TOL, maxiter=CK_MAXIT)
    launches = k2.resident_cg_launches
    rows = prof.trace_report(tb_dir, top=None)
    k2_rows = [r for r in rows if "two_phase_kernel" in r["op"]]
    k2_us = sum(r["total_us"] for r in k2_rows)
    q_ms = queued_ms(lambda: resident_stencil_cg(a128, b128, tol=TOL,
                                                 maxiter=CK_MAXIT),
                     calls=5)
    ov = prof.overlap_report(tb_dir)
    top = [(r["op"][:48], round(r["total_us"], 1)) for r in rows[:4]]
    print(f"[{card}] PF trace of one K2 solve at 128^3 "
          f"({int(res.iterations)} iterations): trace_report gives K2's "
          f"kernel {k2_us / 1e3:.3f} ms device time over "
          f"{sum(r['count'] for r in k2_rows)} launch(es); queued events "
          f"{q_ms:.3f} ms per solve (profiler/events "
          f"{k2_us / 1e3 / q_ms:.3f}); top device ops {top}; "
          f"overlap_report {json.dumps(ov)}")
    check(k2_rows and k2_us > 0, "PF: trace_report did not name K2's kernel "
          "with a device time")
    check(launches == 1, "PF: the traced solve did not launch K2")
    shutil.rmtree(tb_dir, ignore_errors=True)
    print(f"PF: {time.perf_counter() - t_phase:.1f} s")
    return launches


def profiling_child() -> int:
    """PF in a child process with its own CUDA context: a CPU and CUDA
    profiler session (``trace``) leaves the later CUDA-only sessions of
    the same process reading no device time (PERF.md §7).  Relays the
    child's output and returns K2's launches in its traced solve."""
    t0 = time.perf_counter()
    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--profiling-phase"],
            capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        fail("PF: the profiling child did not end within 300 s")
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        print("\n".join(lines))
        sys.stderr.write(out.stderr[-3000:])
        fail(f"PF: the profiling child exited with {out.returncode}")
    for line in lines[:-1]:
        print(line)
    launches = int(json.loads(lines[-1])["pf_launches"])
    print(f"PF child: {time.perf_counter() - t0:.1f} s")
    return launches


def profiling_main() -> None:
    """The child's entry: PF alone, its launches as the last line."""
    from cgx_torch.kernels import _build

    if not torch.cuda.is_available():
        fail("PF: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.library()
    launches = profiling_phase(dev, card_line())
    print(json.dumps({"pf_launches": launches}))


DIST_SHARDS = 4          # shards of D5's kernel checks


def free_port() -> int:
    """A free TCP port on localhost for the process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_phases(dev, card, dias):
    """D: distribution on one card (``cgx_torch.dist``).

    D1–D3, the path as a user drives it on an NCCL group of one rank:
    ``dist_fused_cg`` on the 224³ stencil (b = ones, history) and on DIA-7
    192³ under Jacobi (seeded b), ``dist_fused_cg_multi`` on DIA-27 160³
    under Jacobi with B (n, 4); each equal to its single-card solve
    (``fused_stencil_cg``, ``fused_dia_cg``, ``fused_dia_cg_multi``) bit for
    bit, iterations and history too.  K3's and K5's launch counters and the
    collective counters are read around these three solves only: one
    all-reduce after every kernel launch, two at each solve's start.  D4,
    ``dist_cg_solve`` on DIA-7 128³ under Jacobi against ``cg_solve`` with
    ``JacobiPrecond`` (the same loop).  D5, the CUDA K3 A and K5 A of shard
    r of 4, their ghost planes cut from the neighbouring shards, against
    the whole grid's product, q bit for bit (224³ stencil, DIA-7 192³,
    DIA-27 160³ with its mirror taps), and their cross-rank-mode kernel B
    against the plain versions (x', r', p' bit for bit, the fp64 sums to
    1e-12).  D6, times: the distributed K3 and K5 iterations against the
    single-card ones, CUDA events around whole solves in turns.  Returns
    the extra keys of the K3 and K5 entries and the row mesh, whose group
    the DW phases go on using."""
    import torch.distributed as dist

    import cgx_torch
    from cgx_torch import dist as tdist
    from cgx_torch.dist import halo
    from cgx_torch.io.poisson import poisson3d_dia27
    from cgx_torch.kernels import fused_engine as k3
    from cgx_torch.kernels import fused_multi as k5
    from cgx_torch.kernels.fused_cg import build_fused, fused_stencil_cg
    from cgx_torch.kernels.fused_dia_cg import (build_fused_dia, dia_prep,
                                                dia_shard_engine,
                                                fused_dia_cg)

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tdist.initialize(f"tcp://localhost:{free_port()}", 1, 0, device="cuda")
    mesh = tdist.make_row_mesh(1)
    check(dist.get_backend() == "nccl" and mesh.size == 1
          and mesh.device == dev, "D: not an NCCL group of one rank")
    print(f"D NCCL group of one rank on {mesh.device}: formed in "
          f"{time.perf_counter() - t0:.2f} s")

    a224 = cgx_torch.poisson3d_stencil(*N224)
    b224 = torch.ones(a224.shape[0], dtype=torch.float32, device=dev)
    a7 = dias["DIA-7 192^3"]
    b7 = seeded_rhs(a7.shape[0], dev)
    t0 = time.perf_counter()
    d160 = poisson3d_dia27(*N160, variable=True, seed=SEED, device=dev)
    print(f"D DIA-27 160^3 built in {time.perf_counter() - t0:.1f} s")
    b160 = seeded_block(d160.shape[0], K_MULTI, SEED + 23, dev)
    solvers = {
        "224^3 stencil": (
            lambda: fused_stencil_cg(a224, b224, tol=TOL,
                                     maxiter=MAXIT_HIST,
                                     track_history=True),
            lambda: tdist.dist_fused_cg(a224, b224, mesh, tol=TOL,
                                        maxiter=MAXIT_HIST,
                                        track_history=True)),
        "DIA-7 192^3": (
            lambda: fused_dia_cg(a7, b7, tol=TOL, maxiter=MAXIT_HIST),
            lambda: tdist.dist_fused_cg(a7, b7, mesh, jacobi=True, tol=TOL,
                                        maxiter=MAXIT_HIST)),
        "DIA-27 160^3 k=4": (
            lambda: k5.fused_dia_cg_multi(d160, b160, tol=TOL,
                                          maxiter=MAXIT_HIST),
            lambda: tdist.dist_fused_cg_multi(d160, b160, mesh, jacobi=True,
                                              tol=TOL, maxiter=MAXIT_HIST)),
    }
    refs = {label: single() for label, (single, _) in solvers.items()}
    torch.cuda.synchronize()

    # -- D1-D3: the distributed solves, counted -------------------------------
    k3.fused_a_launches = k3.fused_b_launches = 0
    k5.multi_a_launches = k5.multi_b_launches = 0
    halo.reset_counters()
    got = {label: run() for label, (_, run) in solvers.items()}
    torch.cuda.synchronize()
    launches = {"k3_a": k3.fused_a_launches, "k3_b": k3.fused_b_launches,
                "k5_a": k5.multi_a_launches, "k5_b": k5.multi_b_launches}
    comm = halo.counters()
    print(f"D1-D3 launches: {launches}; collectives {comm}")
    check(all(v > 0 for v in launches.values()),
          f"D: a kernel of the distributed path did not launch: {launches}")
    check(comm["all_reduces"] == 2 * len(solvers) + sum(launches.values()),
          f"D: not one all-reduce after every kernel: {comm}, {launches}")
    check(comm["all_gathers"] == comm["sends"] == 0,
          f"D: one rank sent or gathered: {comm}")
    for label, res in got.items():
        ref = refs[label]
        same = (torch.equal(res.x, ref.x)
                and torch.equal(res.iterations, ref.iterations)
                and torch.equal(res.history, ref.history)
                and torch.equal(res.residual_norm_sq, ref.residual_norm_sq))
        its = res.iterations.reshape(-1).tolist()
        print(f"D {label}: iterations {its} (single card "
              f"{ref.iterations.reshape(-1).tolist()}), converged "
              f"{res.converged.reshape(-1).tolist()}; equal to the "
              f"single-card solve bit for bit: {same}")
        check(bool(torch.all(res.converged)), f"D {label} did not converge")
        check(same, f"D {label}: the distributed solve differs from the "
              "single-card one")

    # -- D4: dist_cg_solve against cg_solve --------------------------------------
    a128 = scaled_dia7(N128, dev)
    b128 = seeded_rhs(a128.shape[0], dev)
    part = tdist.partition_dia(a128, 1)
    t0 = time.perf_counter()
    res_d = tdist.dist_cg_solve(part, b128, mesh, jacobi=True, tol=TOL,
                                maxiter=SOLVER_MAXIT)
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_s = cgx_torch.cg_solve(
        a128, b128, tol=TOL, maxiter=SOLVER_MAXIT,
        preconditioner=cgx_torch.JacobiPrecond.from_matrix(a128))
    torch.cuda.synchronize()
    t_s = time.perf_counter() - t0
    dx = rel(res_d.x, res_s.x)
    print(f"D4 dist_cg_solve DIA-7 128^3 Jacobi: {int(res_d.iterations)} "
          f"iterations (cg_solve {int(res_s.iterations)}), |x - x_cg| / "
          f"|x_cg| {dx:.3e} (bit for bit: {torch.equal(res_d.x, res_s.x)}); "
          f"host {t_d:.2f} s (cg_solve {t_s:.2f} s)")
    check(bool(res_d.converged), "D4 did not converge")
    check(int(res_d.iterations) == int(res_s.iterations) and dx <= 1e-6,
          "D4: dist_cg_solve left cg_solve's trajectory")

    # -- D5: shard r of 4 with ghost planes against the whole grid -----------
    errs = {"k3_a": 0.0, "k3_b": 0.0, "k5_a": 0.0, "k5_b": 0.0}
    shards = DIST_SHARDS
    whole3 = {"224^3 stencil": build_fused(a224, torch.float32),
              "DIA-7 192^3": build_fused_dia(a7, torch.float32)[0]}
    for label, eng in whole3.items():
        p = seeded_rhs(eng.n, dev)
        q_whole = eng.kernel_a(p)[0]
        plane, nl = eng.ny * eng.nz, eng.n // shards
        for r in range(shards):
            rows = slice(r * nl, (r + 1) * nl)
            if eng.planes is None:
                se = k3.FusedCG(eng.nx // shards, eng.ny, eng.nz, eng.taps,
                                coeffs=eng.coeffs,
                                shard=k3.Shard(r, shards))
            else:
                se = build_fused_dia(a7, torch.float32, n_shards=shards,
                                     rank=r)[0]
            pe = halo.cut_ghost_rows(p, r, shards, plane)
            q, s = se.kernel_a_ext(pe)
            q_ref, s_ref = se.kernel_a_ext_reference(pe)
            x = 0.5 * p[rows]
            rz = torch.sum(p[rows].double() ** 2).float()
            out = se.kernel_b_ext(rz, s, x, p[rows], p[rows], q)
            out_ref = se.kernel_b_ext_reference(rz, s, x, p[rows], p[rows], q)
            torch.cuda.synchronize()
            errs["k3_a"] = max(errs["k3_a"],
                               float((q - q_whole[rows]).abs().max()),
                               float((q - q_ref).abs().max()))
            errs["k3_b"] = max([errs["k3_b"]] + [
                float((g - w).abs().max()) for g, w in zip(out[:3],
                                                           out_ref[:3])])
            same_a = torch.equal(q, q_whole[rows]) and torch.equal(q, q_ref)
            same_b = all(torch.equal(g, w) for g, w in zip(out[:3],
                                                           out_ref[:3]))
            dev_a = float(((s - s_ref).abs() / s_ref.abs()).max())
            dev_b = float(((out[3] - out_ref[3]).abs()
                           / out_ref[3].abs()).max())
            print(f"D5 K3 {label} shard {r} of {shards}: A's q equal to the "
                  f"whole grid's rows and to the plain version bit for bit: "
                  f"{same_a} (sums within {dev_a:.1e}); cross-rank B equal "
                  f"to its plain version bit for bit: {same_b} (sums within "
                  f"{dev_b:.1e})")
            check(same_a and same_b and dev_a <= 1e-12 and dev_b <= 1e-12,
                  f"D5 K3 {label} shard {r} disagrees")
    prep160 = dia_prep(d160, torch.float32)
    nx, ny, nz, taps, coeffs, planes, _, w, sym = prep160
    whole5 = k5.FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs, planes=planes,
                             weight=w, sym=sym)
    pb = seeded_block(whole5.n, K_MULTI, SEED + 29, dev).T.contiguous()
    q_whole = whole5.kernel_a(pb)[0]
    plane, nl = ny * nz, whole5.n // shards
    for r in range(shards):
        rows = slice(r * nl, (r + 1) * nl)
        se = dia_shard_engine(prep160, torch.float32, k3.Shard(r, shards),
                              engine=k5.FusedCGMulti)[0]
        pe = halo.cut_ghost_rows(pb, r, shards, plane)
        q, s = se.kernel_a_ext(pe)
        q_ref, s_ref = se.kernel_a_ext_reference(pe)
        x = 0.5 * pb[:, rows].contiguous()
        rz = torch.sum(pb[:, rows].double() ** 2, dim=1).float()
        pr = pb[:, rows].contiguous()
        out = se.kernel_b_ext(rz, s, x, pr, pr, q)
        out_ref = se.kernel_b_ext_reference(rz, s, x, pr, pr, q)
        torch.cuda.synchronize()
        errs["k5_a"] = max(errs["k5_a"],
                           float((q - q_whole[:, rows]).abs().max()),
                           float((q - q_ref).abs().max()))
        errs["k5_b"] = max([errs["k5_b"]] + [
            float((g - v).abs().max()) for g, v in zip(out[:3], out_ref[:3])])
        same_a = torch.equal(q, q_whole[:, rows]) and torch.equal(q, q_ref)
        same_b = all(torch.equal(g, v) for g, v in zip(out[:3], out_ref[:3]))
        dev_a = float(((s - s_ref).abs() / s_ref.abs()).max())
        dev_b = float(((out[3] - out_ref[3]).abs() / out_ref[3].abs()).max())
        print(f"D5 K5 DIA-27 160^3 k={K_MULTI} shard {r} of {shards} "
              f"(march {se.a_design() == k5._MARCH}): A's Q equal to the "
              f"whole grid's rows and to the plain version bit for bit: "
              f"{same_a} (sums within {dev_a:.1e}); cross-rank B equal to "
              f"its plain version bit for bit: {same_b} (sums within "
              f"{dev_b:.1e})")
        check(same_a and same_b and dev_a <= 1e-12 and dev_b <= 1e-12,
              f"D5 K5 shard {r} disagrees")

    # -- D6: times ------------------------------------------------------------------
    # The engines' solves alone (the operator prepared once), the
    # cross-rank mode (an NCCL all-reduce after each kernel) beside the
    # single-card mode, in turns.
    e7 = build_fused_dia(a7, torch.float32)
    e7d = build_fused_dia(a7, torch.float32, group=mesh)
    nx, ny, nz, taps, coeffs, planes, e27, w, sym = prep160
    b27 = (e27[:, None] * b160).T.contiguous()
    engines = {
        "224^3 stencil": (build_fused(a224, torch.float32),
                          k3.FusedCG(*N224, whole3["224^3 stencil"].taps,
                                     coeffs=whole3["224^3 stencil"].coeffs,
                                     group=mesh), b224),
        "DIA-7 192^3": (e7[0], e7d[0], e7[1] * b7),
        "DIA-27 160^3 k=4": (
            k5.FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs, planes=planes,
                            weight=w, sym=sym),
            dia_shard_engine(prep160, torch.float32, k3.shard_of(mesh),
                             engine=k5.FusedCGMulti)[0], b27)}
    times = {}
    for label, (single, multi_rank, b) in engines.items():
        its = int(refs[label].iterations.reshape(-1)[0])
        t_dist, t_single = time_pair(
            lambda: multi_rank.solve(b, tol=TOL, maxiter=MAXIT_HIST),
            lambda: single.solve(b, tol=TOL, maxiter=MAXIT_HIST), reps=3)
        times[label] = (t_dist / its * 1e3, t_single / its * 1e3)
        print(f"[{card}] D6 {label}: distributed (NCCL, one rank) "
              f"{times[label][0]:.2f} us/iter, single card "
              f"{times[label][1]:.2f} us/iter ({t_dist / t_single:.3f}x; "
              f"{its} iterations; events around the engine's solve, in "
              f"turns)")
    # What one all-reduce of the iteration's two doubles costs the host
    # (calls enqueued behind a spin kernel) and the card (queued events).
    sums = torch.zeros(2, dtype=torch.float64, device=dev)
    halo.reset_counters()
    ar_host = host_us(lambda: halo.all_reduce(sums, mesh.group))
    ar_dev = queued_ms(lambda: halo.all_reduce(sums, mesh.group)) * 1e3
    print(f"[{card}] D6 one NCCL all-reduce of 2 doubles (one rank): "
          f"host {ar_host:.2f} us a call, device {ar_dev:.2f} us a call "
          f"(queued events); two an iteration")
    print(f"D: {time.perf_counter() - t_phase:.1f} s")

    def keys(kernel, t, err, **more):
        return {"dist_launches": launches[kernel],
                "dist_us_per_iter": t[0], "single_us_per_iter": t[1],
                "dist_shard_max_abs_err": err, **more}

    k3_t, k5_t = times["224^3 stencil"], times["DIA-27 160^3 k=4"]
    dia7 = {"dist_dia7_us_per_iter": times["DIA-7 192^3"][0],
            "single_dia7_us_per_iter": times["DIA-7 192^3"][1],
            "all_reduce_host_us": ar_host, "all_reduce_device_us": ar_dev}
    return {"fused_kernel_a": keys("k3_a", k3_t, errs["k3_a"], **dia7),
            "fused_kernel_b": keys("k3_b", k3_t, errs["k3_b"], **dia7),
            "fused_multi_a": keys("k5_a", k5_t, errs["k5_a"]),
            "fused_multi_b": keys("k5_b", k5_t, errs["k5_b"])}, mesh


DW_SHARDS = 4            # shards of DW1's shard products


def dist_wbell_phases(dev, card, thermal, mesh, hp_figures):
    """DW1–DW3: the WBELL engine on row-group shards and the df64
    refinement across ranks (``cgx_torch.dist.wbell``, ``.hp``) at the
    thermal2 stand-in's full size, on D's NCCL group of one rank.

    DW1: ``partition_wbell(thermal2, 4)`` built both ways (host seconds),
    the per-shard build's planes the global build's; for each shard r of
    4, K7 over shard r's row layout with its halo group slabs cut from the
    whole internal x (no traffic) equals its rows of the whole matrix's K7
    product bit for bit, and K8 at k = 4 over the shard's tier plan (which
    holds the shard's K7 layout) its rows of the whole K8 product.  DW2,
    the paths as a user drives them: ``dist_wbell_cg_solve`` (Jacobi, a
    seeded b) and ``dist_wbell_cg_solve_multi`` (k = 4, K8) held beside
    ``wbell_cg_solve`` and ``wbell_cg_solve_multi`` (iterations within 1 %,
    x within 1e-4), K7's and K8's launches and the collectives counted
    around the first distributed run, µs per iteration of both in turns.
    DW3, ``make_dist_ir_df64_solver`` (two seeded b) and its multi-RHS form
    (k = 4) to a TRUE relres ≤ 1.5e-6 in fp64, beside HP's single-card
    figures.  Returns the extra keys of K7's and K8's entries."""
    import cgx_torch
    from cgx_torch.dist import halo
    from cgx_torch.dist import hp as dhp
    from cgx_torch.dist import wbell as dw
    from cgx_torch.kernels import wbell as kw
    from cgx_torch.sparse import wbell as sw

    a, op = thermal
    n = a.shape[0]
    a64 = torch.sparse_csr_tensor(a.indptr, a.col_indices, a.values.double(),
                                  size=a.shape)

    def relres64(b, x):
        """TRUE ‖b − A·x‖/‖b‖ in fp64 on the card (b, x any dtype)."""
        b = torch.as_tensor(b).to(dev).double()
        r = b - (a64 @ x.to(dev).double()[:, None])[:, 0]
        return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))

    # -- DW1. the shard products ---------------------------------------------
    t_phase = time.perf_counter()
    parts = {}
    for per_shard in (False, True):
        t0 = time.perf_counter()
        parts[per_shard] = (dw.partition_wbell(a, DW_SHARDS,
                                               per_shard=per_shard),
                            time.perf_counter() - t0)
    (part, t_g), (part_s, t_s) = parts[False], parts[True]
    same_planes = all(
        getattr(part, f) == getattr(part_s, f)
        for f in ("gs", "halo_lo", "halo_hi", "nt_local", "ng_real"))
    for d in range(DW_SHARDS):
        kg = np.abs(part.values[d]).reshape(len(part.values[d]), -1).any(1)
        ks = np.abs(part_s.values[d]).reshape(len(part_s.values[d]),
                                              -1).any(1)
        same_planes = same_planes and all(
            np.array_equal(getattr(part, f)[d][kg], getattr(part_s, f)[d][ks])
            for f in ("values", "lc", "p_og", "p_ga"))
    print(f"DW1 partition_wbell(thermal2, {DW_SHARDS}) on the host: global "
          f"build {t_g:.1f} s, per-shard build {t_s:.1f} s; gs {part.gs} "
          f"groups, halos {part.halo_lo}/{part.halo_hi} groups, nt_local "
          f"{part.nt_local}, {part.values.shape[1]} planes a shard; the "
          f"per-shard build's planes are the global build's: {same_planes}")
    check(same_planes, "DW1: the per-shard build's planes differ")
    del parts, part_s
    xs = seeded_block(n, 4, SEED + 53, dev)
    xo = torch.stack([op.to_internal(xs[:, c]) for c in range(4)])
    plan = kw.build_tier_plan(op)
    y7 = kw.wbell_spmm(op, xo[:1])
    y8 = kw.wbell_spmm_tiered(plan, xo)
    xp = torch.stack([part.to_internal(xs[:, c]) for c in range(4)])
    gs = part.gs
    for r in range(DW_SHARDS):
        t0 = time.perf_counter()
        mem0 = torch.cuda.memory_allocated(dev)
        loc = part.local(r, dev)
        tiers = dw._local_tiers(part, loc)
        torch.cuda.synchronize()
        t_loc = time.perf_counter() - t0
        held = (torch.cuda.memory_allocated(dev) - mem0) / 1e6
        plans = part._cache[("tier_plans",)]
        kept_off = sum(v[r].nbytes for v in (
            part.values, part.lc, part.p_og, part.p_ga, plans.values,
            plans.lc, plans.packed, plans.origin)) / 1e6
        x_ext = halo.cut_halo_rows(xp.movedim(0, 1), r, DW_SHARDS,
                                   part.halo_lo, part.halo_hi).movedim(1, 0)
        y7r = dw.local_wbell_product(loc, x_ext[:1])
        y8r = dw.local_wbell_product(loc, x_ext, tiers)
        torch.cuda.synchronize()
        rows = slice(r * gs, (r + 1) * gs)
        s7 = torch.equal(y7r, y7[:, rows])
        s8 = torch.equal(y8r, y8[:, rows])
        print(f"DW1 shard {r} of {DW_SHARDS} ({loc.rows.nnz} nonzeros, "
              f"its row layout and tier plan on the card in {t_loc:.2f} s, "
              f"holding {held:.1f} MB there (its planes and tier plan, "
              f"{kept_off:.1f} MB, stay on the host), "
              f"the plan holding the shard's K7 layout: "
              f"{tiers.rows is loc.rows}): K7 k=1 equal to the whole "
              f"product's rows bit for bit: {s7}; K8 k=4: {s8}")
        check(s7 and s8 and tiers.rows is loc.rows,
              f"DW1 shard {r}: the shard product differs from the whole")
        # Only the layout and the diagonal go to the card: the storages
        # they hold, each in a block that the caching allocator may leave
        # up to 1 MiB larger than asked (it splits off no smaller rest).
        stores = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                  for t in (loc.diag, *(getattr(loc.rows, f) for f in (
                      "values", "cols", "sbase", "rowmap", "sptr", "x0",
                      "xlen")))}
        check(held * 1e6 <= sum(stores.values()) + len(stores) * 2**20,
              f"DW1 shard {r}: {held:.1f} MB on the card for a "
              f"{sum(stores.values()) / 1e6:.1f} MB layout and diagonal")
        # The next shard's bytes are read from a card without this one's.
        part._cache.clear()
        del loc, tiers
    del part, plan, xp, y7, y8
    print(f"DW1: {time.perf_counter() - t_phase:.1f} s")

    # -- DW2. the distributed WBELL solves -----------------------------------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    part1 = dw.partition_wbell(a, mesh.size)
    dw._local_tiers(part1, part1.local(mesh.rank, dev))
    torch.cuda.synchronize()
    print(f"DW2 partition_wbell(thermal2, {mesh.size}) with its shard's row "
          f"layout and tier plan: {time.perf_counter() - t0:.1f} s")
    b = seeded_rhs(n, dev)
    B = seeded_block(n, K_MULTI, SEED + 59, dev)
    plan = kw.build_tier_plan(op)
    cases = {
        "k=1": (lambda: dw.dist_wbell_cg_solve(
                    part1, b, mesh, tol=TOL, maxiter=MAXIT_WBELL,
                    preconditioner="jacobi"),
                lambda: cgx_torch.wbell_cg_solve(
                    op, b, tol=TOL, maxiter=MAXIT_WBELL, jacobi=True)),
        f"k={K_MULTI}": (lambda: dw.dist_wbell_cg_solve_multi(
                    part1, B, mesh, tol=TOL, maxiter=MAXIT_WBELL,
                    jacobi=True),
                lambda: cgx_torch.wbell_cg_solve_multi(
                    op, B, tol=TOL, maxiter=MAXIT_WBELL, jacobi=True,
                    tier_plan=plan))}
    launches = {"k7": 0, "k8": 0}
    us = {}
    for label, (dist_run, single_run) in cases.items():
        multi = label != "k=1"
        # The path as a user drives it, counted: its launches, collectives
        # and layout builds read around it alone.
        kw.wbell_resident_launches = kw.wbell_tiered_launches = 0
        builds = sw.row_layout_builds
        halo.reset_counters()
        out = {}
        t_d1 = event_ms(lambda: out.setdefault("res", dist_run()))
        k7, k8 = kw.wbell_resident_launches, kw.wbell_tiered_launches
        comm = halo.counters()
        built = sw.row_layout_builds - builds
        res = out["res"]
        t_s1 = event_ms(lambda: out.setdefault("ref", single_run()))
        ref = out["ref"]
        # Then one more of each, in reverse order (dist, single, single,
        # dist): ms per solve by events.
        t_s2, t_d2 = event_ms(single_run), event_ms(dist_run)
        its = res.iterations.reshape(-1).tolist()
        its_s = ref.iterations.reshape(-1).tolist()
        top = max(its)
        launches["k7"] += k7
        launches["k8"] += k8
        t_d, t_s = (t_d1 + t_d2) / 2, (t_s1 + t_s2) / 2
        us[label] = (t_d / top * 1e3, t_s / max(its_s) * 1e3)
        xd, xr = res.x.reshape(n, -1), ref.x.reshape(n, -1)
        cols = range(xd.shape[1])
        dx = max(rel(xd[:, j], xr[:, j]) for j in cols)
        rr = [relres64(B[:, j] if multi else b, xd[:, j]) for j in cols]
        print(f"[{card}] DW2 dist_wbell_cg_solve{'_multi' if multi else ''}"
              f" thermal2 {label} Jacobi (one NCCL rank): iterations {its} "
              f"(single card {its_s}), converged "
              f"{res.converged.reshape(-1).tolist()}, |x - x_single| / "
              f"|x_single| {dx:.3e}, true relres (fp64) "
              f"{[f'{v:.3e}' for v in rr]}; {us[label][0]:.2f} us/iter "
              f"distributed, {us[label][1]:.2f} single card "
              f"({t_d / t_s:.3f}x; events around each solve, in turns "
              f"dist, single, single, dist)")
        print(f"DW2 {label} counted run: K7 {k7} and K8 {k8} launches; "
              f"collectives {comm} ({(comm['all_reduces'] - (1 if multi else 2)) / top:.2f} "
              f"all-reduces an iteration, the one all-gather at the "
              f"boundary); row layouts built {built}")
        check(bool(torch.all(res.converged)), f"DW2 {label} did not converge")
        check(all(abs(i - j) <= 0.01 * j for i, j in zip(its, its_s)),
              f"DW2 {label}: iterations {its} vs {its_s}")
        check(dx <= 1e-4, f"DW2 {label}: x differs by {dx}")
        check(built == 0, f"DW2 {label}: the solve built a row layout")
        # Two all-reduces an iteration after one (the block) or two (the
        # threshold, r₀'s dots) before the loop; one all-gather, at the
        # boundary; no message on one rank.
        check(comm == {"sends": 0, "recvs": 0,
                       "all_reduces": (1 if multi else 2) + 2 * top,
                       "all_gathers": 1},
              f"DW2 {label}: collectives {comm} for {top} iterations")
        check((k7, k8) == ((0, top) if multi else (top, 0)),
              f"DW2 {label}: K7 {k7}, K8 {k8} launches for {top} "
              f"iterations")
    del plan, part1, cases
    print(f"DW2: {time.perf_counter() - t_phase:.1f} s")

    # -- DW3. the df64 refinement across ranks -------------------------------
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 61)
    t0 = time.perf_counter()
    solve = dhp.make_dist_ir_df64_solver(a, mesh, tol=TOL,
                                         inner_precond="jacobi")
    solve_k = dhp.make_dist_ir_df64_solver_multi(a, mesh, tol=TOL)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    kw.wbell_resident_launches = kw.wbell_tiered_launches = 0
    runs = {}
    for name in ("b1", "b2"):
        bv = rng.standard_normal(n)
        t0 = time.perf_counter()
        res, info = solve(bv)
        runs[name] = (bv, res, info, time.perf_counter() - t0)
    Bk = rng.standard_normal((n, K_MULTI))
    t0 = time.perf_counter()
    res_k, info_k = solve_k(Bk)
    t_k = time.perf_counter() - t0
    k7, k8 = kw.wbell_resident_launches, kw.wbell_tiered_launches
    launches["k7"] += k7
    launches["k8"] += k8
    hp_single = " ".join(f"{nm} {o} outer/{i} inner/{ms / 1e3:.2f} s"
                         for nm, (o, i, ms) in hp_figures.items())
    for name, (bv, res, info, secs) in runs.items():
        rr = relres64(torch.from_numpy(bv), res.x.hi.double() + res.x.lo.double())
        print(f"[{card}] DW3 dist IR-df64 thermal2 Jacobi {name} (one NCCL "
              f"rank): {info['outer']} outer cycles, "
              f"{info['inner_iterations']} inner iterations, true relres "
              f"(fp64) {rr:.3e} (the loop's {info['relres']:.3e}), "
              f"{secs:.2f} s")
        check(rr <= 1.5e-6, f"DW3 {name}: true relres {rr}")
    rrk = [relres64(torch.from_numpy(Bk[:, j]),
                    res_k.x.hi[:, j].double() + res_k.x.lo[:, j].double())
           for j in range(K_MULTI)]
    print(f"[{card}] DW3 dist IR-df64 multi thermal2 k={K_MULTI} (K8): "
          f"{info_k['outer']} outer cycles, {info_k['inner_iterations']} "
          f"inner iterations, true relres (fp64) per column "
          f"{[f'{v:.3e}' for v in rrk]}, {t_k:.2f} s; K7 {k7} and K8 {k8} "
          f"launches in DW3; host build of both solvers {t_build:.1f} s; "
          f"HP's single-card figures (other seeded b): {hp_single}")
    check(all(v <= 1.5e-6 for v in rrk), f"DW3 multi: true relres {rrk}")
    check(k7 > 0 and k8 > 0, f"DW3: K7 {k7}, K8 {k8} launches")
    print(f"DW3: {time.perf_counter() - t_phase:.1f} s")
    return {"wbell_resident": {"dist_launches": launches["k7"],
                               "dist_us_per_iter": us["k=1"][0],
                               "single_us_per_iter": us["k=1"][1]},
            "wbell_tiered": {"dist_launches": launches["k8"],
                             "dist_us_per_iter": us[f"k={K_MULTI}"][0],
                             "single_us_per_iter": us[f"k={K_MULTI}"][1]}}


SS_NAMES = "bcsstk17"      # SS's escalation sweep (main's --names)
LINK_SLAB = 1024           # floats of SC's one-rank all-gather (4 KiB)
RF_ITERS = 30              # the reference's run-full count (31 updates)


def scaling_phase(dev, card, dias, mesh):
    """SC, on D's NCCL group of one rank: ``comm_report`` of
    ``partition_dia`` of DIA-7 192³ at 4 shards under the card's
    ``LinkModel``; ``measure_scaling`` of DIA-7 128³ at the group's one
    rank, its iterations those of ``cg_solve`` with the same Jacobi and b;
    and the costs ``LinkModel`` quotes: one all-reduce of an fp64 word and
    one all-gather of a 4 KiB slab at one rank, CUDA events around 100
    calls, beside the host's µs per call."""
    import dataclasses as dc

    import torch.distributed as dist

    import cgx_torch
    from cgx_torch.bench.scaling import LinkModel, comm_report, measure_scaling
    from cgx_torch.dist.partition import partition_dia

    t_phase = time.perf_counter()
    link = LinkModel()
    t0 = time.perf_counter()
    part = partition_dia(dias["DIA-7 192^3"], 4)
    rep = comm_report(part, link=link)
    print(f"[{card}] SC comm_report(DIA-7 192^3, 4 shards) under "
          f"{dc.asdict(link)} (partition {time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(rep)}")
    check(rep["mode"] == "halo" and 0 < rep["predicted_efficiency"] <= 1
          and rep["comm_bytes_per_iter_per_chip"]
          == (part.halo_lo + part.halo_hi) * 4, f"SC: comm_report {rep}")
    del part

    a128 = scaled_dia7(N128, dev)
    b128 = seeded_rhs(a128.shape[0], dev)
    out = measure_scaling(a128, b128, [1], tol=TOL, maxiter=SOLVER_MAXIT,
                          device=dev)
    ref = cgx_torch.cg_solve(a128, b128, tol=TOL, maxiter=SOLVER_MAXIT,
                             preconditioner=cgx_torch.JacobiPrecond
                             .from_matrix(a128))
    print(f"[{card}] SC measure_scaling(DIA-7 128^3, [1]) at one NCCL rank: "
          f"{json.dumps(out)}; cg_solve {int(ref.iterations)} iterations")
    check(len(out) == 1 and out[0]["devices"] == 1
          and out[0]["efficiency"] == 1.0 and out[0]["seconds"] > 0
          and out[0]["iterations"] == int(ref.iterations),
          f"SC: measure_scaling {out}")
    del a128, b128

    word = torch.zeros(1, dtype=torch.float64, device=dev)
    slab = torch.ones(LINK_SLAB, dtype=torch.float32, device=dev)
    gathered = torch.empty(LINK_SLAB * mesh.size, dtype=torch.float32,
                           device=dev)
    costs = {}
    for label, fn in (
            ("all_reduce", lambda: dist.all_reduce(word, group=mesh.group)),
            ("all_gather", lambda: dist.all_gather_into_tensor(
                gathered, slab, group=mesh.group))):
        fn()
        torch.cuda.synchronize()
        ev = statistics.median(event_ms(fn, inner=100) for _ in range(5))
        costs[label] = (ev * 1e3, host_us(fn))
    print(f"[{card}] SC one NCCL rank: an all-reduce of one fp64 word "
          f"{costs['all_reduce'][0]:.2f} us by events (host "
          f"{costs['all_reduce'][1]:.2f} us a call), an all-gather of "
          f"{LINK_SLAB * 4} B {costs['all_gather'][0]:.2f} us (host "
          f"{costs['all_gather'][1]:.2f}); LinkModel quotes "
          f"psum_latency_us {link.psum_latency_us}, ici_latency_us "
          f"{link.ici_latency_us}")
    check(all(v[0] > 0 for v in costs.values()), f"SC: costs {costs}")
    print(f"SC: {time.perf_counter() - t_phase:.1f} s")


def _quiet_main(main, argv):
    """``(exit code, stdout)`` of a harness's ``main(argv)`` run in
    process; its stderr passes through."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            code = main(argv)
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue()


def sweep_phases(dev, card, thermal, bundle):
    """SS and DR.  SS, the SuiteSparse sweep as a user drives it:
    ``bench_matrix("thermal2", a, True, fmt="auto", reps=1)`` on W1's CSR
    ``a``, all four preconditioners, K7's launches read around it (the
    none, jacobi and block_jacobi rows on WBELL, ic0 on CSR; every row
    converged, no error); the jacobi row's iterations equal to one
    unchunked ``cg_solve`` over the same WBELL operator (W1's: the build
    is deterministic), preconditioner and right-hand side; then
    ``main(["--names", "bcsstk17", "--escalate-df64", "--reps", "1"])``
    in process, each fp32 row that did not converge carrying a df64 record
    at TRUE relres ≤ 1.5·tol.  DR, the warm df64 run: ``python -m
    cgx_torch.bench.df64_rhs --name thermal2 --rhs 1`` (its build and its
    own TRUE-residual checks) in a child process that runs beside SS (its
    host build, ~40 s, overlaps SS's host-bound loops; SS's times are
    taken beside it), then in process ``--multi 4 --operator`` NF's
    thermal2 bundle with K8's launches read around it, and ``--multi 4
    --operator`` a missing path, which must exit non-zero.  Returns K7's
    and K8's launches."""
    import cgx_torch
    from cgx_torch.bench import df64_rhs, suitesparse
    from cgx_torch.kernels import wbell as kw

    a, op = thermal
    root = os.path.dirname(os.path.abspath(__file__))
    dr_args = ["--name", "thermal2", "--rhs", "1"]
    t_dr = time.perf_counter()
    dr_child = subprocess.Popen(
        [sys.executable, "-m", "cgx_torch.bench.df64_rhs"] + dr_args,
        cwd=root, env=dict(os.environ, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    t_phase = time.perf_counter()
    kw.wbell_resident_launches = 0
    rows = suitesparse.bench_matrix("thermal2", a, True, fmt="auto", reps=1,
                                    device=dev)
    torch.cuda.synchronize()
    k7 = kw.wbell_resident_launches
    for rec in rows:
        print(f"[{card}] SS {json.dumps(rec)}")
    by = {r["precond"]: r for r in rows}
    print(f"SS thermal2 launches: K7 {k7}")
    check(k7 > 0, "SS: the WBELL rows did not launch K7")
    check([by[p]["format"] for p in ("none", "jacobi", "block_jacobi",
                                     "ic0")] == ["wbell"] * 3 + ["csr"],
          f"SS: formats {[(p, r['format']) for p, r in by.items()]}")
    check(all("error" not in r and r["converged"] and r["relres"] <= TOL
              for r in rows), "SS: a thermal2 row failed or missed tol")
    # The jacobi row's own right-hand side (its last timed one) through
    # one unchunked cg_solve over the same WBELL operator and Jacobi.
    base = np.random.default_rng(0).standard_normal(a.shape[0]).astype(
        np.float32)
    b_row = op.to_internal(torch.from_numpy(
        (base * (1 + 0.001 * 1)).astype(np.float32)).to(dev))
    m = cgx_torch.JacobiPrecond(inv_diag=op.to_internal(
        (1.0 / a.diagonal()).to(torch.float32)))
    ref = cgx_torch.cg_solve(op, b_row, tol=TOL, maxiter=8000,
                             preconditioner=m)
    print(f"SS jacobi row {by['jacobi']['iterations']} iterations, one "
          f"unchunked cg_solve {int(ref.iterations)}")
    check(by["jacobi"]["iterations"] == int(ref.iterations),
          "SS: the chunked jacobi row left the unchunked trajectory")
    del ref, b_row, m

    t0 = time.perf_counter()
    code, out = _quiet_main(suitesparse.main,
                            ["--names", SS_NAMES, "--escalate-df64",
                             "--reps", "1"])
    recs = [json.loads(line) for line in out.strip().splitlines()]
    for rec in recs:
        print(f"[{card}] SS {json.dumps(rec)}")
    print(f"SS main --names {SS_NAMES} --escalate-df64: exit {code} in "
          f"{time.perf_counter() - t0:.1f} s")
    check(code == 0 and len(recs) == 4, f"SS main: exit {code}, "
          f"{len(recs)} rows")
    for rec in recs:
        if rec.get("converged", True):
            continue
        d = rec.get("df64", {})
        check(d.get("true_relres", np.inf) <= 1.5 * TOL,
              f"SS: {rec['precond']}'s df64 record {d}")
    print(f"SS: {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    try:
        out, err = dr_child.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        dr_child.kill()
        dr_child.communicate()
        fail("DR df64_rhs --name thermal2: no exit within 600 s")
    code = dr_child.returncode
    lines = out.strip().splitlines()
    rec = json.loads(lines[-1]) if code == 0 and lines else {}
    print(f"[{card}] DR python -m cgx_torch.bench.df64_rhs "
          f"{' '.join(dr_args)} (beside SS, {time.perf_counter() - t_dr:.1f} "
          f"s from its start): exit {code}; {json.dumps(rec)}; stderr tail "
          f"{err.strip().splitlines()[-3:]}")
    check(code == 0 and rec.get("outer", 0) > 0
          and max(rec["relres"] + [rec["first_rhs_relres"]]) <= 1.5 * TOL,
          f"DR --name thermal2: exit {code}")
    kw.wbell_tiered_launches = 0
    code, out = _quiet_main(df64_rhs.main,
                            ["--name", "thermal2", "--rhs", "1", "--multi",
                             str(K_MULTI), "--operator", bundle])
    torch.cuda.synchronize()
    k8 = kw.wbell_tiered_launches
    rec = json.loads(out.strip().splitlines()[-1]) if code == 0 else {}
    print(f"[{card}] DR {json.dumps(rec)}")
    print(f"DR --multi {K_MULTI} launches: K8 {k8}")
    check(code == 0 and rec.get("operator") == "loaded" and k8 > 0
          and max(np.ravel(rec["relres"] + [rec["first_rhs_relres"]]))
          <= 1.5 * TOL, f"DR --multi {K_MULTI}: exit {code}, K8 {k8}")
    missing = os.path.join(os.path.dirname(bundle), "missing_bundle.npz")
    code, _ = _quiet_main(df64_rhs.main, ["--multi", str(K_MULTI),
                                          "--operator", missing])
    print(f"DR --multi --operator <missing>: exit {code!r}")
    check(code not in (0, None) and not os.path.exists(missing),
          "DR: --multi with a missing --operator did not exit non-zero")
    print(f"DR: {time.perf_counter() - t_phase:.1f} s")
    return k7, k8


def numpy_cg(a64, b, updates):
    """``updates`` CG updates in fp64 from x = 0 (the port's recurrence),
    by scipy's CSR product on the host."""
    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rz = r @ r
    for _ in range(updates):
        q = a64 @ p
        alpha = rz / (p @ q)
        x += alpha * p
        r -= alpha * q
        rz_new = r @ r
        p = r + (rz_new / rz) * p
        rz = rz_new
    return x


def reference_phase(dev, card):
    """RF: ``build_full_problem()`` (n = 52,269, 345 diagonals), the port's
    solve (``solve_full``: 31 updates in fp32 on the card) against a
    float64 numpy CG of the same 31 updates, at ``main``'s bar (rel <
    1e-3), and ``main`` itself where the reference tree is present."""
    from cgx_torch.bench import reference_full
    from cgx_torch.sparse.types import csr_from_scipy

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    s, b = reference_full.build_full_problem()
    a = csr_from_scipy(s, device=dev)
    n_diags = len(np.unique(s.indices - np.repeat(np.arange(s.shape[0]),
                                                  np.diff(s.indptr))))
    print(f"RF build_full_problem: n {s.shape[0]}, {s.nnz} nonzeros, "
          f"{n_diags} diagonals, built in {time.perf_counter() - t0:.1f} s")
    check(s.shape[0] == 52269 and n_diags == 345, "RF: the problem's shape")
    x, t_cold, t_warm = reference_full.solve_full(a, b, RF_ITERS,
                                                  device=dev)
    x64 = numpy_cg(s, b, RF_ITERS + 1)
    rel_dx = float(np.linalg.norm(x - x64) / np.linalg.norm(x64))
    print(f"[{card}] RF {RF_ITERS + 1} updates: fp32 on the card "
          f"{t_warm * 1e3:.2f} ms (first {t_cold * 1e3:.2f} ms, events), "
          f"against fp64 numpy CG: rel {rel_dx:.3e} (bar 1e-3)")
    check(np.isfinite(x).all() and rel_dx < 1e-3, f"RF: rel {rel_dx}")
    if os.path.exists(os.path.join(reference_full.REF_DIR, "cg.c")):
        code, out = _quiet_main(reference_full.main, [])
        print(f"[{card}] RF main: exit {code}, {out.strip()[-300:]}")
        check(code == 0, f"RF main: exit {code}")
    else:
        print(f"RF main: the reference binary was not built (no tree at "
              f"{reference_full.REF_DIR})")
    print(f"RF: {time.perf_counter() - t_phase:.1f} s")


def entry_phase(dev, card):
    """GE: ``cgx_torch.graft_entry.entry()`` on the card (its default),
    converged with ‖r‖ ≤ 1e-5·‖b‖."""
    from cgx_torch.graft_entry import entry

    t_phase = time.perf_counter()
    fn, args = entry()
    check(args[0].data.device == dev and args[1].device == dev,
          "GE: entry() did not build on the card")
    x, its, rr = fn(*args)
    torch.cuda.synchronize()
    bn = float(torch.linalg.vector_norm(args[1]))
    print(f"GE entry(): {int(its)} iterations, |r| {float(rr) ** 0.5:.3e} "
          f"(bar 1e-5 * {bn:.3e}), x {tuple(x.shape)}")
    check(int(its) < 200 and float(rr) ** 0.5 <= 1e-5 * bn
          and bool(torch.isfinite(x).all()), "GE: entry() did not converge")
    print(f"GE: {time.perf_counter() - t_phase:.1f} s")


def cli_phase(dev, card, bundle, k2_its):
    """CLI: ``python -m cgx_torch`` in subprocesses on the card, each
    printing its seconds: ``solve`` of the 128³ stencil (its iterations
    K2's count in process, ``k2_its``), ``solve --input`` of NF's thermal2
    bundle under Jacobi (the df64 refinement it implies), ``bench`` of the
    128³ stencil (one JSON line, its path ``select_backend``'s), ``info``,
    and ``solve --devices 2``, which must exit non-zero and name torchrun
    (one card holds one NCCL rank).  Removes the bundle."""
    import cgx_torch

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t_phase = time.perf_counter()

    def start(args):
        return subprocess.Popen([sys.executable, "-m", "cgx_torch"] + args,
                                cwd=root, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def finish(proc, args, t0):
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"CLI {' '.join(args)}: no exit within 600 s")
        print(f"CLI python -m cgx_torch {' '.join(args)}: exit "
              f"{proc.returncode} in {time.perf_counter() - t0:.1f} s; "
              f"stderr tail {err.strip().splitlines()[-3:]}")
        return proc.returncode, out, err

    def run(args):
        return finish(start(args), args, time.perf_counter())

    grid = "x".join(str(d) for d in N128)
    # Two that barely touch the card run beside the others.
    side = {}
    for args in (["info"], ["solve", "--poisson", grid, "--devices", "2"]):
        side[args[0]] = (start(args), args, time.perf_counter())
    code, _, err = run(["solve", "--poisson", grid, "--format", "stencil"])
    m = re.search(r"iterations=(\d+) converged=True", err)
    check(code == 0 and m is not None and int(m.group(1)) == k2_its,
          f"CLI solve {grid}: exit {code}, want iterations={k2_its} "
          f"converged=True (K2's count in process; the JAX package's 300)")
    code, _, err = run(["solve", "--input", bundle, "--precond", "jacobi"])
    os.remove(bundle)
    check(code == 0 and "format=ir_df64 (prebuilt bundle)" in err
          and "converged=True" in err and "true_relres=" in err,
          f"CLI solve --input bundle: exit {code}")
    code, out, err = run(["bench", "--poisson", grid, "--format", "stencil",
                          "--reps", "3"])
    lines = out.strip().splitlines()
    rec = json.loads(lines[-1]) if code == 0 and lines else {}
    a128 = cgx_torch.poisson3d_stencil(*N128)
    route = cgx_torch.select_backend(
        a128, torch.ones(a128.shape[0], device=dev))
    print(f"[{card}] CLI bench {grid} stencil: {json.dumps(rec)}")
    check(len(lines) == 1 and rec.get("path") == route == "resident_stencil"
          and rec.get("device") == "cuda" and rec.get("converged") is True
          and rec.get("iterations") == k2_its,
          f"CLI bench: exit {code}, {lines}, in-process route {route}")
    code, out, err = finish(*side["info"])
    check(code == 0 and torch.cuda.get_device_name(0) in out,
          f"CLI info: exit {code}")
    code, out, err = finish(*side["solve"])
    check(code != 0 and "torchrun --nproc-per-node 2" in err,
          f"CLI solve --devices 2 on one card: exit {code}, {err[-300:]}")
    print(f"CLI: {time.perf_counter() - t_phase:.1f} s")


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        sys.exit(2)

    import cgx_torch
    from cgx_torch.kernels import _build
    from cgx_torch.kernels import fused_resident as k2
    from cgx_torch.kernels import stencil as k1
    from cgx_torch.kernels.fused_cg import stencil_taps

    check(not {"jax", "cgx", "experiments"} & set(sys.modules),
          "the port imported JAX, the JAX package or its experiments")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    card = card_line()

    # -- 1. device --------------------------------------------------------
    print(f"device: {name}")
    print(f"nvidia-smi: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"toolchain: {json.dumps(_build.probe())}")

    # -- 2. build ---------------------------------------------------------
    so, secs = _build.build()
    _build.library()
    print(f"build: {so.name} in {secs:.1f} s")

    # -- 3. K1 against its plain version ------------------------------------
    rng = np.random.default_rng(SEED)
    k1_err = {}
    for dims in (N128, (37, 41, 53)):
        nx, ny, nz = dims
        x = torch.from_numpy(
            rng.standard_normal(nx * ny * nz).astype(np.float32)).to(dev)
        before = k1.stencil3d_spmv_launches
        y = k1.stencil3d_spmv(x, nx=nx, ny=ny, nz=nz)
        torch.cuda.synchronize()
        y_ref = k1.stencil3d_spmv_reference(x, nx, ny, nz)
        y_first = k1._before_spmv(x, nx, ny, nz)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        scale = float(y_ref.abs().max())
        # The form cgx_stencil3d_march (csrc/stencil.cu) chooses.
        w = 4 if (nz % 4 == 0 and x.data_ptr() % 16 == 0
                  and y.data_ptr() % 16 == 0) else 1
        same = torch.equal(y, y_first)
        print(f"K1 {nx}x{ny}x{nz} ({'float4' if w == 4 else 'scalar'} "
              f"form): max|y-y_ref| = {err:.3e} (bound 1e-6 * "
              f"{scale:.3e}); equal to the first design bit for bit: {same}")
        check(k1.stencil3d_spmv_launches == before + 1,
              "K1 launch counter did not move")
        check(err <= 1e-6 * scale, f"K1 disagrees at {dims}: {err}")
        check(same, f"K1 differs from its first design at {dims}")
        k1_err[dims] = err

    pf_launches = profiling_child()

    # -- 4. the main path, as users drive it --------------------------------
    a128 = cgx_torch.poisson3d_stencil(*N128)
    a224 = cgx_torch.poisson3d_stencil(*N224)
    cases = [(a128, nm, b) for nm, b in rhs_set(N128, dev).items()]
    n224 = a224.shape[0]
    cases.append((a224, "ones", torch.ones(n224, dtype=torch.float32,
                                           device=dev)))
    for a, _, b in cases:
        check(cgx_torch.select_backend(a, b) == "resident_stencil",
              f"{a.nx}^3 routed to {cgx_torch.select_backend(a, b)}")

    k1.stencil3d_spmv_launches = 0
    k2.resident_cg_launches = 0
    results = []
    for a, nm, b in cases:
        before = k2.resident_cg_launches
        res = cgx_torch.auto_solve(a, b, tol=TOL)
        r32 = b - cgx_torch.spmv(a, res.x)
        torch.cuda.synchronize()
        check(k2.resident_cg_launches == before + 1,
              "auto_solve did not launch K2 exactly once")
        results.append((a, nm, b, res, r32))
    launches = {"k1": k1.stencil3d_spmv_launches,
                "k2": k2.resident_cg_launches}
    print(f"main path launches: K1 {launches['k1']}, K2 {launches['k2']}")
    check(launches["k1"] >= len(cases) and launches["k2"] == len(cases),
          f"main path did not run through both kernels: {launches}")

    k2_err = 0.0
    for a, nm, b, res, r32 in results:
        its = int(res.iterations)
        x_ref, _, _, k_ref, _, _ = k2.resident_cg_reference(
            stencil_taps(a), b, tol=TOL, maxiter=a.shape[0])
        its_ref = int(k_ref)
        # The fp64 solution of the same system, for the forward error.
        x64 = cgx_torch.cg_solve(a.matvec, b.double(), tol=1e-10,
                                 maxiter=5000).x
        relres, relres_ref = true_relres(a, b, res.x), true_relres(a, b, x_ref)
        relres32 = float(torch.linalg.vector_norm(r32)
                         / torch.linalg.vector_norm(b))
        dx = float(torch.linalg.vector_norm(res.x - x_ref)
                   / torch.linalg.vector_norm(x_ref))
        fwd = float(torch.linalg.vector_norm(res.x.double() - x64)
                    / torch.linalg.vector_norm(x64))
        if a is a128:
            k2_err = max(k2_err, float((res.x - x_ref).abs().max()))
        print(f"K2 {a.nx}^3 b={nm}: iterations {its} (plain {its_ref}), "
              f"converged {bool(res.converged)}, true relres (fp64) "
              f"{relres:.3e} (plain {relres_ref:.3e}), relres via spmv "
              f"(fp32) {relres32:.3e}, |x-x_ref|/|x_ref| {dx:.3e}, "
              f"|x-x64|/|x64| {fwd:.3e}")
        check(bool(res.converged), f"{a.nx}^3 b={nm} did not converge")
        # The fp32 recurrence drifts from the true residual (x is summed in
        # fp32 over hundreds of updates); the kernel must drift no more
        # than its plain version does on the same input.
        check(relres <= 1.5 * relres_ref,
              f"{a.nx}^3 b={nm}: true relres {relres} vs plain {relres_ref}")
        check(abs(its - its_ref) <= 2,
              f"{a.nx}^3 b={nm}: {its} vs plain {its_ref} iterations")
        check(dx <= 1e-4, f"{a.nx}^3 b={nm}: x differs by {dx}")
        check(fwd <= 1e-4, f"{a.nx}^3 b={nm}: forward error {fwd}")
        if a is a128 and nm == "ones":
            print(f"K2 128^3 b=ones: {its} iterations; the JAX package "
                  f"took {JAX_ITERS_ONES_128} (BENCH_r05.json) — a check "
                  f"of the trajectory, not a speed figure")
            check(295 <= its <= 305, f"b=ones took {its} iterations")

    b1 = results[0][2]
    r_a = cgx_torch.auto_solve(a128, b1, tol=TOL)
    r_b = cgx_torch.auto_solve(a128, b1, tol=TOL)
    same = (int(r_a.iterations) == int(r_b.iterations)
            and torch.equal(r_a.x, r_b.x))
    print(f"K2 reproducible: {same}")
    check(same, "two K2 runs on the same input differ")

    # -- 5. times -----------------------------------------------------------
    nx, ny, nz = N128
    n = nx * ny * nz
    nnz = 7 * n - 6 * nx * ny
    # K1 beside its first design in turns, cold (x over 8 buffers of 8 MB,
    # past the 50 MB L2) and warm in device time, the host's µs per call,
    # and events around 20 calls from Python (beside the plain version).
    xs = [torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        dev) for _ in range(K1_COLD_BUFFERS)]
    x = xs[0]
    k1t = k1_times(card, {
        "march": lambda v: k1.stencil3d_spmv(v, nx=nx, ny=ny, nz=nz),
        "first design": lambda v: k1._before_spmv(v, nx, ny, nz)}, xs,
        plain=lambda v: k1.stencil3d_spmv_reference(v, nx, ny, nz))
    t_k1 = k1t["march"]["events_ms"]
    t_k1p = k1t["plain"]["events_ms"]
    # One PyTorch call that computes K1's function: conv3d with the seven
    # taps in a 3x3x3 kernel, padding 1, in full fp32 (cuDNN's TF32 off).
    torch.backends.cudnn.allow_tf32 = False
    wk = torch.zeros((1, 1, 3, 3, 3), device=dev)
    wk[0, 0, 1, 1, 1] = 6.0
    for tap in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                (1, 1, 2)):
        wk[(0, 0) + tap] = -1.0
    xv = x.view(1, 1, nx, ny, nz)

    def conv():
        return torch.nn.functional.conv3d(xv, wk, padding=1)

    check(maxrel(conv().reshape(-1), k1.stencil3d_spmv_reference(
        x, nx, ny, nz)) <= 1e-6, "conv3d does not compute K1's function")
    conv()
    t_conv = statistics.median(event_ms(conv, inner=20) for _ in range(5))
    k1_b = bound(8 * n, 2 * nnz - n)
    d_k1, d_k1f = k1t["march"]["cold_ms"], k1t["first design"]["cold_ms"]
    print(f"[{card}] K1 128^3: {t_k1 * 1e3:.2f} us/SpMV by events "
          f"({nnz / (t_k1 * 1e-3) / 1e9:.1f} Gnnz/s); device cold "
          f"{d_k1 * 1e3:.2f} us ({k1_b[0] / d_k1:.3f} of the "
          f"{k1_b[0] * 1e3:.2f} us bound; the first design "
          f"{d_k1f * 1e3:.2f}, {d_k1 / d_k1f:.3f}x); host "
          f"{k1t['march']['host_us']:.2f} us per call (first design "
          f"{k1t['first design']['host_us']:.2f}); plain "
          f"{t_k1p * 1e3:.2f} us ({nnz / (t_k1p * 1e-3) / 1e9:.1f} Gnnz/s); "
          f"conv3d {t_conv * 1e3:.2f} us")

    k2_ms, k2_its = k2_times(dev, card, (a128, a224))

    # -- 6. the Jacobi-PCG path over DIA operators ---------------------------
    from cgx_torch.io.poisson import poisson3d_dia27
    from cgx_torch.kernels import fused_dia_cg as fdia
    from cgx_torch.kernels import fused_engine as k3
    from cgx_torch.kernels.fused_cg import build_fused
    from cgx_torch.solve.auto import FUSED_MIN_ROWS

    t0 = time.perf_counter()
    dias = {"DIA-7 192^3": scaled_dia7(N192, dev),
            "DIA-27 128^3": poisson3d_dia27(*N128, variable=True,
                                            seed=SEED).to(dev)}
    print(f"DIA operators built in {time.perf_counter() - t0:.1f} s")
    dia_cases = []
    for label, a in dias.items():
        m = cgx_torch.JacobiPrecond.from_matrix(a)
        n = a.shape[0]
        rhs = {"ones": torch.ones(n, dtype=torch.float32, device=dev),
               "random": torch.from_numpy(np.random.default_rng(SEED)
                                          .standard_normal(n)
                                          .astype(np.float32)).to(dev)}
        for nm, b in rhs.items():
            route = cgx_torch.select_backend(a, b, m)
            check(route == "resident_dia", f"{label} routed to {route}")
            dia_cases.append((label, a, m, nm, b))

    k2.resident_cg_launches = k2.resident_dia_launches = 0
    k3.fused_a_launches = k3.fused_b_launches = 0
    dia_results = []
    for label, a, m, nm, b in dia_cases:
        before = k2.resident_dia_launches
        res = cgx_torch.auto_solve(a, b, tol=TOL, preconditioner=m)
        torch.cuda.synchronize()
        check(k2.resident_dia_launches == before + 1,
              f"{label} b={nm}: auto_solve did not launch K2 (planes) once")
        check(bool(res.converged), f"{label} b={nm} did not converge")
        dia_results.append(res)
    launches["k2_planes"] = k2.resident_dia_launches
    print(f"DIA path launches: K2 planes {launches['k2_planes']}, K2 const "
          f"{k2.resident_cg_launches}, K3 A {k3.fused_a_launches}")
    check(launches["k2_planes"] == len(dia_cases)
          and k2.resident_cg_launches == 0 and k3.fused_a_launches == 0,
          "the DIA path did not run through K2's planes mode alone")

    # -- 7. the history path (K3) ----------------------------------------
    a7, m7 = dias["DIA-7 192^3"], dia_cases[0][2]
    b7 = dia_cases[0][4]
    b224 = torch.ones(n224, dtype=torch.float32, device=dev)
    hist_cases = [("DIA-7 192^3 b=ones", a7, m7, b7),
                  ("stencil 224^3 b=ones", a224, None, b224)]
    for _, a, _, b in hist_cases:
        check(b.shape[0] >= FUSED_MIN_ROWS, "history case below the "
              "two-pass engine's size")
    k2.resident_cg_launches = k2.resident_dia_launches = 0
    k3.fused_a_launches = k3.fused_b_launches = 0
    hist_results = []
    for label, a, m, b in hist_cases:
        before = (k3.fused_a_launches, k3.fused_b_launches)
        res = cgx_torch.auto_solve(a, b, tol=TOL, preconditioner=m,
                                   maxiter=MAXIT_HIST, track_history=True)
        torch.cuda.synchronize()
        its = int(res.iterations)
        da = k3.fused_a_launches - before[0]
        db = k3.fused_b_launches - before[1]
        print(f"K3 {label}: {its} iterations, {da} A and {db} B launches, "
              f"history length {res.history.shape[0]}")
        check(bool(res.converged), f"K3 {label} did not converge")
        check(da >= its + 1 and db >= its,
              f"K3 {label}: {da} A / {db} B launches for {its} iterations")
        check(res.history.shape == (MAXIT_HIST + 1,),
              f"K3 {label}: history of shape {tuple(res.history.shape)}")
        hist_results.append(res)
    launches["k3_a"] = k3.fused_a_launches
    launches["k3_b"] = k3.fused_b_launches
    check(k2.resident_cg_launches == 0 and k2.resident_dia_launches == 0,
          "the history path launched K2")

    # -- 8. held against the plain versions and fp64 ----------------------
    k2p_err = 0.0
    x64_cache = {}

    def fp64_solution(label, nm, a, b):
        """The fp64 Jacobi-PCG (DIA) or CG (stencil) solution of the same
        system, to 1e-10."""
        if (label, nm) not in x64_cache:
            if isinstance(a, cgx_torch.DIAMatrix):
                a64 = a.astype(torch.float64)
                x64_cache[label, nm] = cgx_torch.cg_solve(
                    a64, b.double(), tol=1e-10, maxiter=20000,
                    preconditioner=cgx_torch.JacobiPrecond.from_matrix(
                        a64)).x
            else:
                x64_cache[label, nm] = cgx_torch.cg_solve(
                    a.matvec, b.double(), tol=1e-10, maxiter=20000).x
        return x64_cache[label, nm]

    def relres_of(a, b, x):
        if isinstance(a, cgx_torch.DIAMatrix):
            b64 = b.double()
            r = b64 - cgx_torch.spmv(a.astype(torch.float64), x.double())
            return float(torch.linalg.vector_norm(r)
                         / torch.linalg.vector_norm(b64))
        return true_relres(a, b, x)

    for (label, a, m, nm, b), res in zip(dia_cases, dia_results):
        nx, ny, nz, taps, coeffs, planes, e, w, sym = fdia.dia_prep(
            a, torch.float32, inv_diag=m.inv_diag)
        x_s, _, _, k_ref, _, _ = k2.resident_cg_reference(
            (nx, ny, nz, taps, coeffs), e * b, planes=planes, weight=w,
            sym=sym, tol=TOL, maxiter=a.shape[0])
        x_ref = e * x_s
        x64 = fp64_solution(label, nm, a, b)
        hold(f"K2 planes {label} b={nm}", res.x, int(res.iterations),
             x_ref, int(k_ref), relres_of(a, b, res.x),
             relres_of(a, b, x_ref), rel(res.x, x64), rel(x_ref, x64))
        k2p_err = max(k2p_err, float((res.x - x_ref).abs().max()))

    engines = {}
    for (label, a, m, b), res in zip(hist_cases, hist_results):
        if m is None:
            eng, e = build_fused(a, torch.float32), None
        else:
            eng, e, _ = fdia.build_fused_dia(a, torch.float32,
                                             inv_diag=m.inv_diag)
        engines[label] = (eng, e, b)
        b_s = b if e is None else e * b
        ref = eng.solve_reference(b_s, tol=TOL, maxiter=MAXIT_HIST,
                                  track_history=True)
        x_ref = ref.x if e is None else e * ref.x
        x64 = fp64_solution(label.split(" b=")[0], "ones", a, b)
        hold(f"K3 {label}", res.x, int(res.iterations), x_ref,
             int(ref.iterations), relres_of(a, b, res.x),
             relres_of(a, b, x_ref), rel(res.x, x64), rel(x_ref, x64))
        k = min(int(res.iterations), int(ref.iterations))
        h, h_ref = res.history[:k + 1], ref.history[:k + 1]
        hdev = float(((h - h_ref).abs() / h_ref.abs()).max())
        print(f"K3 {label}: history over {k + 1} entries within {hdev:.3e} "
              f"of the plain version's (bound 2e-2)")
        check(hdev <= 2e-2, f"K3 {label}: history differs by {hdev}")
        # The whole solve through the first design of K3's kernels (the
        # same-run "before"): bit for bit, and both timed in turns.
        k3_solve_versus_first(f"[{card}] §8", label, eng, b_s, tol=TOL,
                              maxiter=MAXIT_HIST)

    r_a = cgx_torch.auto_solve(a7, b7, tol=TOL, preconditioner=m7)
    r_b = cgx_torch.auto_solve(a7, b7, tol=TOL, preconditioner=m7)
    same_k2 = (int(r_a.iterations) == int(r_b.iterations)
               and torch.equal(r_a.x, r_b.x))
    h_a = cgx_torch.auto_solve(a7, b7, tol=TOL, preconditioner=m7,
                               maxiter=MAXIT_HIST, track_history=True)
    h_b = cgx_torch.auto_solve(a7, b7, tol=TOL, preconditioner=m7,
                               maxiter=MAXIT_HIST, track_history=True)
    same_k3 = (int(h_a.iterations) == int(h_b.iterations)
               and torch.equal(h_a.x, h_b.x)
               and torch.equal(h_a.history, h_b.history))
    print(f"K2 planes reproducible: {same_k2}; K3 reproducible: {same_k3}")
    check(same_k2 and same_k3, "two runs on the same input differ")

    # K3's kernels one step each at the main path's shapes.
    k3_err = {"a": 0.0, "b": 0.0}
    for label, (eng, e, b) in engines.items():
        p = b if e is None else e * b
        q, pq, qq = eng.kernel_a(p)
        q_ref, pq_ref, qq_ref = eng.kernel_a_reference(p)
        err_a = float((q - q_ref).abs().max())
        rz = torch.sum(p * p)
        out = eng.kernel_b(rz, pq_ref, qq_ref, torch.zeros_like(p), p, p,
                           q_ref)
        out_ref = eng.kernel_b_reference(rz, pq_ref, qq_ref,
                                         torch.zeros_like(p), p, p, q_ref)
        err_b = max(float((g - r).abs().max())
                    for g, r in zip(out[:3], out_ref[:3]))
        scale_b = max(float(r.abs().max()) for r in out_ref[:3])
        sums_dev = max(abs(float(g) - float(r)) / abs(float(r))
                       for g, r in ((pq, pq_ref), (qq, qq_ref))
                       + tuple(zip(out[3:], out_ref[3:])))
        print(f"K3 one step, {label}: A max|q-q_ref| {err_a:.3e} (bound "
              f"1e-6 * {float(q_ref.abs().max()):.3e}), B max|x,r,p - "
              f"plain| {err_b:.3e} (bound 1e-6 * {scale_b:.3e}), sums "
              f"within {sums_dev:.3e} (bound 1e-5)")
        check(err_a <= 1e-6 * float(q_ref.abs().max()), "K3 A disagrees")
        check(err_b <= 1e-6 * scale_b, "K3 B disagrees")
        check(sums_dev <= 1e-5, "K3 sums disagree")
        k3_err["a"] = max(k3_err["a"], err_a)
        k3_err["b"] = max(k3_err["b"], err_b)

    # -- 9. times -----------------------------------------------------------
    k2p_ms = k2_plane_times(dev, card, dias)

    k3_us = {}
    for label, (eng, e, b) in engines.items():
        b_s = b if e is None else e * b
        its = int(eng.solve(b_s, tol=TOL, maxiter=MAXIT_HIST,
                            track_history=True).iterations)
        its_ref = int(eng.solve_reference(b_s, tol=TOL, maxiter=MAXIT_HIST,
                                          track_history=True).iterations)
        t_k, t_p = time_pair(
            lambda: eng.solve(b_s, tol=TOL, maxiter=MAXIT_HIST,
                              track_history=True),
            lambda: eng.solve_reference(b_s, tol=TOL, maxiter=MAXIT_HIST,
                                        track_history=True), reps=3)
        k3_us[label] = (t_k / its * 1e3, t_p / its_ref * 1e3)
        print(f"[{card}] K3 {label} (history): {t_k:.3f} ms/solve, "
              f"{k3_us[label][0]:.2f} us/iter ({its} it); plain {t_p:.3f} "
              f"ms/solve, {k3_us[label][1]:.2f} us/iter ({its_ref} it)")
    its224 = int(cgx_torch.auto_solve(a224, b224, tol=TOL).iterations)
    print(f"[{card}] 224^3 b=ones: K2 constant mode "
          f"{k2_ms[224][0] / its224 * 1e3:.2f} us/iter beside K3 "
          f"{k3_us['stencil 224^3 b=ones'][0]:.2f} us/iter")

    eng7, e7, b7_ = engines["DIA-7 192^3 b=ones"]
    p7 = e7 * b7_
    q7, pq7, qq7 = eng7.kernel_a_reference(p7)
    rz7 = torch.sum(p7 * p7)
    z7 = torch.zeros_like(p7)
    t_a, t_ap = time_pair(lambda: eng7.kernel_a(p7),
                          lambda: eng7.kernel_a_reference(p7), inner=20)
    t_b, t_bp = time_pair(
        lambda: eng7.kernel_b(rz7, pq7, qq7, z7, p7, p7, q7),
        lambda: eng7.kernel_b_reference(rz7, pq7, qq7, z7, p7, p7, q7),
        inner=20)
    # One PyTorch call that computes K3 A's product (without its sums):
    # torch's CSR product of Ã.
    csr7 = scaled_csr(dias["DIA-7 192^3"], e7)
    pc7 = p7[:, None]
    check(maxrel((csr7 @ pc7)[:, 0], q7) <= 1e-5,
          "the CSR product does not compute K3 A's product")
    t_csr7 = statistics.median(event_ms(lambda: csr7 @ pc7, inner=20)
                               for _ in range(5))
    del csr7
    print(f"[{card}] K3 one call from Python at DIA-7 192^3: A "
          f"{t_a * 1e3:.2f} us (plain {t_ap * 1e3:.2f} us; torch's CSR "
          f"product of Ã alone {t_csr7 * 1e3:.2f} us), B "
          f"{t_b * 1e3:.2f} us (plain {t_bp * 1e3:.2f} us)")
    k3a_ms = k3a_versus_first("§9", "DIA-7 192^3 fp32", eng7, p7, card)
    k3b_ms = k3b_versus_first("§9", "DIA-7 192^3 fp32", eng7, card, rz7,
                              pq7, qq7, z7, p7, p7, q7)
    # Kernel B unweighted, in fp32 on the 224³ stencil's path.
    eng224 = build_fused(a224, torch.float32)
    p224 = seeded_rhs(eng224.n, dev)
    q224, pq224, qq224 = eng224.kernel_a_reference(p224)
    k3b224_ms = k3b_versus_first(
        "§9", "224^3 stencil fp32", eng224, card,
        torch.sum(p224.double() ** 2).float(), pq224, qq224, 0.5 * p224,
        p224, p224, q224)
    del p224, q224

    w_entries, thermal = wbell_phases(dev, card)
    m_entries = multi_phases(dev, card, dias)
    b_entries, bells = bsr_phases(dev, card)
    e_entries = proto_phases(dev, card, thermal, bells)
    del bells
    acc_launches = accuracy_phases(dev, card, thermal, dias)
    thermal = thermal[:2]           # the CSR and its WBELL operator, for DW
    x_entries = mixed_phases(dev, card, dias, fp64_solution, relres_of)
    s_entries = sr_phases(dev, card, dias, fp64_solution, relres_of)
    solver_launches = solver_phases(dev, card, dias, fp64_solution)
    d_extra, mesh = dist_phases(dev, card, dias)
    dw_extra = dist_wbell_phases(dev, card, thermal, mesh,
                                 acc_launches["HP_figures"])
    scaling_phase(dev, card, dias, mesh)
    from torch import distributed as torch_dist
    torch_dist.destroy_process_group()
    del mesh
    ss_k7, dr_k8 = sweep_phases(dev, card, thermal,
                                acc_launches["NF_bundle"])
    del thermal
    reference_phase(dev, card)
    entry_phase(dev, card)
    cli_phase(dev, card, acc_launches["NF_bundle"],
              int(results[0][3].iterations))

    # Bounds: each input read once, each output written once (4 B words),
    # against the operations at the fp32 rate.  K1: x in, y out, 2 flops
    # per stored entry.  K2 per solve: b in, x out (its planes and weight
    # in), per iteration the operator's 2 flops per entry plus 10 per row
    # for the dots and updates.  K3 one call: A reads p and its planes and
    # writes q; B reads x, r, p, q, w and writes x, r, p.
    n128 = N128[0] * N128[1] * N128[2]
    k2_b = bound(8 * n128, k2_its[128] * (2 * nnz + 10 * n128))
    n_pl, n_taps, its7 = k2p_ms["DIA-7 192^3"][2:5]
    n192 = N192[0] * N192[1] * N192[2]
    k2p_b = bound((n_pl + 3) * 4 * n192, its7 * n192 * (2 * n_taps + 12))
    k3a_b = bound((eng7.planes.shape[0] + 2) * 4 * eng7.n,
                  eng7.n * (2 * len(eng7.taps) + 4))
    k3b_b = bound(8 * 4 * eng7.n, 12 * eng7.n)

    def entry(name, source, replaces, launches, err, ms, plain_ms, b,
              library_ms=None, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b[0], "bound_by": b[1],
                "library_ms": library_ms, **extra}

    report = {"kernels": [
        entry("stencil3d_spmv", "cgx_torch/csrc/stencil.cu",
              "cgx/kernels/stencil.py:29", launches["k1"], k1_err[N128],
              t_k1, t_k1p, k1_b, t_conv, device_ms=d_k1,
              warm_device_ms=k1t["march"]["warm_ms"],
              host_us=k1t["march"]["host_us"],
              before_ms=k1t["first design"]["events_ms"],
              before_device_ms=d_k1f,
              before_warm_device_ms=k1t["first design"]["warm_ms"],
              before_host_us=k1t["first design"]["host_us"],
              solver_launches=solver_launches),
        entry("resident_cg", "cgx_torch/csrc/resident_cg.cu",
              "cgx/kernels/fused_resident.py:115", launches["k2"], k2_err,
              k2_ms[128][0], k2_ms[128][1], k2_b,
              three_phase_ms=k2_ms[128][2]),
        entry("resident_cg_planes", "cgx_torch/csrc/resident_cg.cu",
              "cgx/kernels/fused_resident.py:115", launches["k2_planes"],
              k2p_err, k2p_ms["DIA-7 192^3"][0], k2p_ms["DIA-7 192^3"][1],
              k2p_b, three_phase_ms=k2p_ms["DIA-7 192^3"][5]),
        entry("fused_kernel_a", "cgx_torch/csrc/fused_engine.cu",
              "cgx/kernels/fused_engine.py:272", launches["k3_a"],
              k3_err["a"], k3a_ms[0], t_ap, k3a_b, t_csr7,
              before_ms=k3a_ms[1]),
        entry("fused_kernel_b", "cgx_torch/csrc/fused_engine.cu",
              "cgx/kernels/fused_engine.py:411", launches["k3_b"],
              k3_err["b"], k3b_ms[0], t_bp, k3b_b, before_ms=k3b_ms[1],
              stencil_224_fp32_ms=k3b224_ms[0],
              stencil_224_fp32_before_ms=k3b224_ms[1]),
    ] + w_entries + m_entries + b_entries + x_entries + s_entries
        + e_entries}
    # The launches of HP, CK and PF, as extra keys on their kernels'
    # entries (no new kernel in those phases).
    extra = {
        "stencil3d_spmv": {"ck_launches": acc_launches["CK_xla"]},
        "resident_cg": {"ck_launches": acc_launches["CK_resident"],
                        "pf_launches": pf_launches},
        "fused_kernel_a": {"ck_launches": acc_launches["CK_fused"]},
        "fused_kernel_b": {"ck_launches": acc_launches["CK_fused_b"]},
        "sr_cg": {"ck_launches": acc_launches["CK_sr"]},
        "wbell_resident": {"hp_launches": acc_launches["HP_k7"],
                           "ss_launches": ss_k7},
        "wbell_tiered": {"hp_launches": acc_launches["HP_k8"],
                         "dr_launches": dr_k8},
    }
    for kernel, keys in list(d_extra.items()) + list(dw_extra.items()):
        extra.setdefault(kernel, {}).update(keys)
    for e in report["kernels"]:
        e.update(extra.get(e["name"], {}))
    check(all(any(e["name"] == nm for e in report["kernels"])
              for nm in extra), "a kernel of HP, CK, PF, D or DW has no "
          "entry")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--profiling-phase"]:
        profiling_main()
        sys.exit(0)
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
