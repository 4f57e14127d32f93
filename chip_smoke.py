"""Drive the PyTorch/CUDA port on one GPU: the MILC Wilson-CG solve and its
batched serving, both also in mixed precision, under a shared-memory budget
and under the plan autotuner's winners, the flat chains' policy instances, the
Ludwig LC-LB timestep, untiled, tuned, under a shared-memory budget,
in every data layout and with bf16 LB storage, the decomposed lattice on a one-rank
mesh (the sharded solve and step), RWKV6-7B and starcoder2-7b serving (prefill and
greedy decode).

    python3 chip_smoke.py [--lattice X Y Z T] [--small X Y Z T]
                          [--ludwig X Y Z] [--ludwig-small X Y Z] [--seed N]

Phases (any failure raises and exits non-zero; nothing is caught):

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the hand-written kernels (src/repro_torch/csrc, one nvcc call)
   while the host generates the problem (random SU(3) gauge field and
   source at ``--lattice``, default (64, 64, 64, 32)); print K4's, K7's,
   K8's and K5L's ptxas report (registers and spills, one line a kernel);
C1. (after L4) K3C, the fused LC chain (molecular field, BE rhs, Q update)
   at ``--ludwig`` in SoA and AoS on the L1 state's q and lap q and random
   w and adv: within 1e-6 x max|plain| of its plain version, against the
   K3L pair's composition (bitwise or not, logged), timed beside its bound
   and the K3L pair; the lc_chain graph's launch in each layout counted;
T4. (after RS1) the solve of phase 4 under ``TargetConfig(smem_bytes=227 *
   1024)``, counted: the plan's ``describe()`` (at (64, 64, 64, 32) the
   finest tile, (1, 1, 1) with t whole), K5T twice an iteration and K5
   never, iterations within 1 and x within rel-L2 1e-5 of phase 4's,
   |M x - b| / |b| < 1e-3; K5T's t and ap bitwise K5's on phase 3's
   inputs, pap within rtol 1e-6 of its plain version and bitwise on a
   rerun (bitwise K5's logged), timed beside K5, its bound and the
   two-launch floor; the same checks at the explicit tile K5T_WALK_TILE,
   whose walk is not the identity;
T5. under the same budget: ``solve_batched`` on S2's four sources (K5T
   batched, each slot bitwise the budgeted solve of its source) and the
   refined solve (K5T's policy instance), each counted, the refined solve
   within 1 iteration and rel-L2 1e-5 of P2's untiled one (bitwise
   logged); K5T batched (4 slots, each bitwise its single launch) and its
   policy instance (ap bitwise K5's policy instance) against their plain
   versions, timed beside K5B and K5's policy instance; at K5T_WALK_TILE
   each batched slot bitwise its single launch and K5's, and the policy
   ap bitwise K5's policy instance;
3. hold every MILC kernel against its plain PyTorch version on the card at
   that lattice and time both (CUDA events, median of several runs); K2's
   sum and fold also bitwise their tree emulation (core/reduce.py's
   ``reduce_tree``, ``fold_tree``, run on the card), as in L2, S1 and P1;
Q1. where ``build/parent`` holds a ``git archive`` of the parent, its K1
   and K2 (site_local.cu and reduce.cu with its own headers, built beside
   phase 2's build as a library of their own, launched with their own
   arguments and partial tables) against this tree's on the same tensors
   (K1 bitwise, K2 within SUM_RTOL or the oracle bound) and timed in turns
   (parent, this, this, parent) beside the library call and the bound, a
   call at a time and replayed from a CUDA graph (the kernels without the
   host's Python: most of a fold's time a call is the host's), at
   phase 3's, S1's (4 slots) and P1's MILC shapes; Q2 the same after L2 at
   L2's and P1's Ludwig shapes; one JSON line before the kernel table;
Q3. (after Q1, where ``build/parent`` holds the parent's tree) the parent's
   K3, K4 and K5 (fused_flat.cu, dslash.cu, wilson_normal.cu,
   wilson_normal_mixed.cu with its own headers, a library of their own) and
   this tree's, both launched
   through their C entry points on the same tensors: cg_xpay, cg_update in
   SoA, AoS and aosoa4 and fed a bf16 ap, both masked over 4 slots; K5 in
   SoA, AoS, aosoa16, over 4 slots, and its policy instance single and over
   4 slots (both on the operator's bf16 copy of u): every
   output (K3's fields and partial rows; K5's t, ap and partial rows)
   bitwise the parent's, timed in turns as Q1 (``torch.addcmul`` beside
   cg_xpay), K5 beside its two-launch design floor; K4 in SoA, AoS,
   aosoa4 and aosoa16, out bitwise the parent's, timed in turns; then K5
   and K4 (in turns) at (256, 32, 32, 32) and (1024, 16, 16, 32) on random
   fields, shorter x-reuse distances, and a 1 GiB device copy; its rows
   join Q1's in the JSON line;
4. with every launch count set to 0, solve M x = b on the "cuda" engine
   (kappa 0.12, hot 0.6, tol 1e-10, max_iter 2000), check
   |M x - b| / |b| < 1e-3 and that every kernel of the path launched;
5. at ``--small`` (default (16, 16, 16, 16)) solve on the "cuda" and the
   "torch" engine, both on the card: iterations within +-1, x within
   rel-L2 1e-4;
S1. the batch instances K3B (cg_update_masked, cg_xpay_masked, dot_prod),
   K5B (wilson_normal, batched) and K2B (the batched sum and fold) at
   ``--lattice`` with 4 slots, vvl 128, in SoA and aosoa16, on phase 2's u:
   slot 1 has mask 0, slot 2 is all-zero, slot 3 is frozen with -0.0 and a
   NaN in its x and r.  Every slot bitwise the single kernel's launch on
   that slot (cg_update, cg_xpay, the product, K2, K5), frozen slots bitwise
   their y inputs, live slots within the stated tolerance of the plain
   versions; timed in SoA (CUDA events, median of 10) beside the bound of
   the bytes this run's mask needs, the plain version and, for the product
   and the sums, torch.mul / torch.sum;
S2. with every count set to 0: ``driver.solve_batched`` at ``--lattice``
   on phase 2's u, four sources from ``fields.random_spinor`` (seeds from
   ``--seed``), one spectrally filtered (6 normal-operator applications,
   converging earlier), one all-zero: each live slot's x, iterations and
   residual bitwise the cuda ``solve`` of its source alone, the filtered
   slot fewer iterations, the empty one 0 and x = 0, residual_check < 1e-3
   a slot, every kernel of the batched path launched; the peak device
   memory, and ms a batched iteration from a second run of cg_batched's
   loop alone (rhs and initial state built first), bitwise the first;
S3. a ``SolveServer`` drain: 4 slots at ``--lattice`` (phase 2's u) with 6
   requests and 2 slots at ``--small`` (phase 5's u) with 3, submitted
   interleaved, so slots drain and refill mid-flight; every outcome bitwise
   the dedicated ``solve``; ticks a bucket, ms a tick by occupancy, solves/s
   against the dedicated solves' sum; the slice's tensors are freed after;
P1. the mixed-precision policy instances against their plain versions, at
   ``--lattice`` (after S3) and ``--ludwig`` (after L5), vvl 128, in soa,
   aos and aosoa16: A, K5's policy instance (wilson_normal_mixed.cu), bf16
   storage ap within one bf16 ulp (plus the fp32 field tolerance where a
   value cancels far below its terms), pap within the oracle bound of the fp64
   sum, fp32 storage bitwise the policy-free ap, run to run the same bits,
   K5B's slots bitwise K5's; B, K5L's (dist2 and u within one bf16 ulp, the
   LB graph under fp32 storage bitwise the policy-free one); C, K3 and K3B
   fed a bf16 ap (bitwise K3 on the widened ap, within tolerance of the
   plain version); D, K2's compensated sum and fold (within the oracle
   bound, also on the block-aligned cancellation fixture at full size,
   where the plain K2 must fall outside it, and on pairs whose lo carries
   the sum, where the fold of the his alone must: core/reduce.py's
   ``cancel_field`` and ``fold_pairs``); the stage-in rounding
   bitwise torch's: bf16.cuh's helper kernel on u and on ties, -0.0, inf,
   NaN and subnormals, the operator's bf16 copy of u (bf16_pack, beside
   ``.to(torch.bfloat16)``), and K5's policy instance's own load of p at
   kappa 0.  Timed in SoA (CUDA events, median of 10; K5's policy instance
   on the bf16 copy of u, as the operator runs it) beside the policy-free
   kernel, the bound of the bytes the kernel moves and the bytes of the
   reference's traffic model;
U1. (after P1-P3, and after P4 at ``--ludwig``) the flat chains' policy
   instances at vvl 128 in soa and aosoa16 against their plain versions:
   K3's (cg_update) at ``--lattice`` on phase 3's inputs, K3L's
   (ludwig_chem_stress, ludwig_lc_update) at ``--ludwig`` on L2's: bf16
   fields within one bf16 ulp, rr within the oracle bound of the kernel's
   own fp32 r_new, the accumulate-only policy's fields bitwise the
   policy-free kernels', the same bits run to run, bf16 inputs bitwise their
   fp32 sources pre-rounded; timed in SoA beside the policy-free kernels;
U2. (after T5) with ``$TARGETDP_TORCH_TUNE_PATH`` a fresh temporary file:
   ``tune_solve_graphs(convergence_cost=True)`` at ``--lattice`` and
   ``tune_step_graphs`` at ``--ludwig``, counted (the policy instances'
   launches), each graph's candidates' µs, failed, rejected and winner
   printed, no candidate failing; a second call of each cached with no sweep
   launch; a ``plan_policy="tuned"`` solve and 10 tuned Ludwig steps,
   counted, running their winners' kernels (phase 4's solve, iterations
   within 1 and x within rel-L2 1e-5, and L3's steps bitwise where no winner
   carries a dtype policy; else finite, logged); a recorded bf16 operator
   winner driving a ``storage="bfloat16"`` solve to |M x - b| / |b| < 1e-3;
   a ``SolveServer`` drain at ``--small`` under "tuned" bitwise the default
   drain.  U1's and U2's numbers print as one JSON line before the kernel
   table;
P2. with every count set to 0: ``solve`` with ``storage="bfloat16"`` (the
   refined solve) on phase 2's u and b: |Mx - b|/|b| < 1e-3, x within
   rel-L2 1e-4 of phase 4's, K5's policy and policy-free instances, K3 fed
   a bf16 ap, K2's compensated fold and the bf16 copy of u launched; inner
   iterations and restarts beside phase 4's iterations, seconds to
   solution;
P3. at ``--small`` on phase 5's u: ``solve_batched`` (4 sources) and a
   2-slot ``SolveServer`` drain of them, the bf16 policy and restarts every
   P3_REFINE iterations: each outcome within P2's checks against the
   full-precision solve and bitwise its one-slot ``solve_batched`` run;
P4. (after L5) with every count set to 0: 10 steps from the L1 state with
   ``storage="bfloat16"``: finite, dist within 1e-2 rel of L3's 10 steps,
   q within 1e-2 of the fp32 steps after 3 (P4_REL says why not 10), the
   bf16 LB step launched; then, its counts set to 0 again, the mass before
   and after summed by a standalone ``target_sum`` under an accumulate
   policy (K2's compensated pass 1, which no driver path runs); 10 steps with
   ``storage="float32"`` bitwise L3's; ms a step beside L3's; at
   ``--ludwig-small`` 10 bf16 steps of the cuda engine within rel-L2 1e-3
   of the torch engine's, both on the card;
   P1-P4's numbers print as one JSON line before the kernel table;
L1. Ludwig ``init_state`` at ``--ludwig`` (default (256, 256, 256), the
   ludwig_small lattice of benchmarks/fig5_scaling.py) on the card;
L2. every Ludwig kernel against its plain version there, timed as in 3;
   K7's out and K5L's dist2 bitwise the plain version (the collision's
   roundings are pinned, csrc/d3q19.cuh), K8's out bitwise too and timed
   beside ``torch.take`` on the 19 V source offsets (built once, outside
   the timing);
Q5. (after L2, where ``build/parent`` holds the parent's tree) the parent's
   K7, K8 and K5L (lb.cu with its own headers, a library of its own)
   against this tree's, both launched through their C entry points on
   L2's dist and force in SoA, AoS, aosoa4 and aosoa16: K7, K8 (beside
   ``torch.take``), ludwig_lb_step, lb_collide_propagate and the policy
   instance; K8's out and K5L's u bitwise the parent's, K7's out and K5L's
   dist2 bitwise the plain version on the card and within 1e-5 x max|plain|
   of the parent's (the policy instance's bf16 dist2 within one bf16 ulp
   of it: the pin moved the fp32 bits), timed in turns (parent, this,
   this, parent), a call at a time; rows in the redesign JSON line;
L3. with every launch count set to 0: ``diagnostics``, 10 ``step``s and one
   ``step_timed`` on the "cuda" engine, ``diagnostics`` again; check that
   every value is finite, the mass drifts by less than 1e-4 relative, the
   free energy does not rise, and every kernel of the step launched;
L4. with every count set to 0: the paper's unfused LB half-step
   ``propagate(collide(d, f))`` against the fused ``collide_propagate(d, f)``
   (benchmarks/fig3_kernels.py:244-247), both timed; dist2 must agree
   bitwise and the collision and propagation kernels must have launched;
L5. at ``--ludwig-small`` (default (32, 32, 32)) 5 steps on the "cuda" and
   the "torch" engine, both on the card: q and dist within rtol 1e-4,
   atol 1e-6;
D1. the kernels on pre-exchanged halos at the full lattices, each against
   its plain version and timed (CUDA events, median of 10) beside its
   bound: after phase 5, K4H (``dslash_halo``, width 1) within FIELD_RTOL
   and K5H (the wilson_normal graph's "pre" kernel) within FIELD_RTOL of
   their plain versions on phase 2's b and u wrap-padded, each also
   against K4's and K5's periodic fields (bitwise or not, logged) and
   timed beside them; after L5, K8H (``propagate_halo`` at width 1, one
   counted call, and width 2) bitwise its plain version and K8's periodic
   launch, beside ``torch.take`` on its 19 source offsets, and K5LH (the
   ludwig_lb_step graph's "pre" kernel) bitwise its plain version and
   K5L's periodic launch, on L2's kind of inputs wrap-padded; K5HO (K5H's
   kernels on box tables: the interior's t and ap, then the shell's t and
   the boundary's ap, T-slabs paired) on the full MILC lattice's split
   (every dim decomposed: the interior (60,60,60,28) and 8 slabs of width
   2) within FIELD_RTOL of the plain box-table schedule and bitwise K5H,
   each part and each paired entry timed beside its byte bound and its
   sector bound, the split and K5H in turns; K5LHO (K5LH on one box) on
   every box of the Ludwig split (the interior (254,254,254) and 6 slabs
   of width 1) bitwise its plain version and K5LH's sites, timed beside the
   bytes each box depends on; the sharded plans' kernels: K5TH (K5H's
   kernels in K5T's tile walk) at the 227 KiB budget's tile of the "pre"
   launch and at K5T_WALK_TILE, tiled K5HO (the ap tables' rows in each
   box's sub-plan tiles of the outer plan K5HO_OUTER) on the full split,
   each bitwise K5H, within FIELD_RTOL of its plain version and timed in
   turns with K5H beside its bound; K9H (K5LH's template under a tile and
   in any layout) at the budget's tile, with and without u (both LB
   graphs), at K9H_COARSE_TILE bitwise its tiled plain version, and in
   aosoa4 read and written in place, each bitwise K5LH and its plain
   version, timed in turns with K5LH beside its bound;
D2. (after D1's MILC half) on a one-rank mesh of four axes, every lattice
   dim decomposed over one (each exchange the self-exchange), with every
   count set to 0 before each: ``make_sharded_solver`` at ``--lattice``
   under ``halo=None`` (K4H twice an iteration) and ``"pre"`` (K5H an
   iteration) and ``"overlap"`` (K5HO's four kernels an iteration, p's
   exchange on a side stream beside the interior's two; no K5H): phase 4's
   iterations +-1, x within rel-L2 1e-4 of phase 4's, every kernel of the
   path launched, "overlap" with "pre"'s iterations and x bitwise; ms an
   iteration beside phase 4's; first, the solve's halo'd spinor at widths
   1 and 2 two ways, bitwise and timed: ``exchange_padded`` against
   ``exchange(halo_pad(...))``; after V1 (whose kernel check wants the
   run's first profiler session), a torch.profiler trace of 3 overlap
   operators (fill, then ``overlap_launch``), the last one read: the
   interior box's kernels and the exchange's copies, their intervals and
   streams, and the ms during which both ran (a serial schedule is
   recorded, not failed); then, counted, the solve under the 227 KiB
   budget under "pre" (K5TH an iteration, no K5H) and "overlap" (the
   reference's default overlap plan: untiled K5HO), each with "pre"'s
   iterations and x bitwise, and 3 applications of the operator through
   ``overlap_launch`` under the explicit tiled plan K5HO_OUTER (tiled
   K5HO's two ap launches each), bitwise its "pre" launch: no driver path
   runs tiled K5HO, since the solver's default overlap plan is untiled and
   an explicit tiled plan_policy would tile its site-local launches too,
   which refuse a tile;
D3. (after D1's Ludwig half) 5 ``make_sharded_step`` steps at
   ``--ludwig`` on a one-rank mesh of three axes from the L1 state,
   counted (K5LH every step): bitwise equal to 5 ``step``s from it
   (within rtol 1e-4, atol 1e-6 with the difference logged where not
   bitwise); then 5 steps under ``halo="overlap"`` (K5LHO on 7 boxes a
   step, no K5LH), bitwise the "pre" and the single steps; 5 steps under
   the 227 KiB budget (K9H in the budget's tiles every step, no K5LH) and
   5 in aosoa4 under an explicit view="block" plan, "pre" and "overlap"
   (K9H reading and writing AoSoA in place), each after one untimed step
   and bitwise the SoA "pre" steps; ms a step beside them; the D phases' numbers are printed as one
   JSON line before the kernel table;
Y1. at the full lattices ((64,64,64,32) and (256,256,256)), every lattice
   kernel of both paths (K1 g5 and the product, K2's sum and fold, K3,
   K4, K5; K7, K8, K5L, K3L, K1L) in each layout of LAYOUT_SPECS (soa,
   aos, aosoa4, aosoa8, aosoa16, aosoa64, aosoa128: the union of the
   paper's Fig. 3 sweeps), vvl 128, on phase 3's and L2's inputs repacked
   on the card: every field (unpacked) and every sum bitwise equal to the
   kernel's SoA launch, and within the stated tolerance of its plain
   version in the same layout (K7, K8 and K5L's dist2 bitwise); timed
   beside the SoA row's bound (the layout does not change the bytes), K8
   beside ``torch.take``;
Y2. with every count set to 0 before each: the solve of phase 4 from
   phase 2's u and b repacked, in each layout (SoA again, for a like
   comparison): phase 4's iteration count, x bitwise equal to phase 4's,
   |M x - b| / |b| < 1e-3, every kernel of the path launched; ms an
   iteration;
Y3. with every count set to 0 before each: 10 steps from the L1 state
   repacked, in each layout and at each vvl of (32, 64, 128, 256) its SAL
   divides (the reference's rule): dist and q bitwise equal to L3's 10
   steps; at vvl 128 ``diagnostics`` equal to SoA's and L4's exhibit
   bitwise equal to its fused launch (both timed), every kernel of both
   paths launched, and one ``step_timed``; ms a step (the paper's Fig. 3
   layout x VVL panel); the
   layouts' numbers are printed as one JSON line before the kernel table;
V1. (after Y2 and after Y3) the block view at full width, with every count
   set to 0 before each: the MILC solve of Y2 in V1_MILC_LAYOUT (aosoa8,
   whose SAL ``block_view_ok`` accepts for the ring-2 halos of p and u)
   under ``LoweringPlan("cuda", vvl=128, bx=1, view="block")``: iterations
   and x bitwise Y2's (phase 4's), |M x - b| / |b| < 1e-3, every kernel of
   the path launched; one block-view CG iteration's launches (the operator
   graph, the update chain, the xpay) under torch.profiler show only the
   hand kernels (no copy or elementwise kernel of a relayout); 10 Ludwig
   steps in V1_LUDWIG_LAYOUT (aosoa4) under the same plan bitwise L3's,
   every kernel of the step launched; the LB step graph in aosoa16 (SAL 16
   does not divide the halo'd inner plane, 258 x 258) under the block plan
   raises before any launch;
RS1. (after Y2) split reductions at full width, with every count set to 0
   before each window: the solve of phase 4 in SoA under
   ``LoweringPlan("cuda", vvl=128, bx=1, rsplit=RSPLIT)``: |M x - b| /
   |b| < 1e-3, iterations within +-1 of phase 4's, x within rel-L2 1e-4,
   rr, pap and the standalone sums folded through K2S (the unsplit fold
   never launched), a second run bitwise the first; ``solve_batched`` of
   two copies of b under the plan, each slot bitwise the split solve
   (K2S batched); the refined solve (storage bfloat16) under the plan,
   within P2's checks (K2S compensated folds pap's pairs); K2S single,
   batched (4 slots) and compensated bitwise ``fold_tree_split`` run on
   the card at rsplit 2, 4 and 16 on phase 3's partial tables and at 1 and
   3 rows; cg_update's and wilson_normal's field outputs bitwise the
   unsplit launch; K2's int32 sum (one component past 2^31, wrapping) and
   max of a 24-component field at ``--lattice`` in SoA, AoS and aosoa16
   bitwise ``torch.sum(dtype=int32)``/``amax``, also under rsplit 4; its
   bf16 sum and max of the LB step's bf16 dist2 (P4's storage) at
   ``--ludwig`` bitwise its tree on the widened field and the sum within
   one bf16 ulp of the fp64 sum rounded; in a counted window of their own,
   the standalone ``target_sum``/``target_max`` of those fields (no driver
   path reduces them); every new kernel timed (CUDA events, median of 10)
   beside its bound, its plain version and ``torch.sum``/``amax`` on the
   same tensor (the folds also from a CUDA graph); one JSON line before
   the kernel table;
T1. on the L1 state, the plan ``default_plan`` picks for the LB half-step
   under a 227 KiB shared-memory budget (at (256, 256, 256): bx 1, by 4,
   bz 64); K9's shared memory a block (none) and its blocks an SM (from
   its ptxas registers); K9 against K5L bitwise for both LB graphs and
   against the plain LB step (``lb_step_plain``) on the whole lattice
   within 1e-5 x max|plain|, timed beside K5L; then against
   ``tiled_plain``, the tile-by-tile plain version, on a slice of 4 x 4 x 2
   tiles ((4, 16, 128) there), logged; then K9 in AoS and aosoa4, on
   aosoa4 through the LB graph under the tiled plan in view="block", and
   its bf16 policy instance, each bitwise K5L's launch in that layout or
   policy and the plain LB step, timed beside K5L;
Q4. (after T1 and after R1, where ``build/parent`` holds the parent's tree)
   the parent's K9 and K10 (lb_tiled.cu and rwkv6.cu with its own headers,
   a library of their own) against this tree's: K9 at T1's lattice and
   tile, for both graphs u bitwise the parent's and dist2 bitwise the plain
   LB step on the card and within 1e-5 x max|plain| of the parent's (the
   collision's pinned roundings moved its bits); K10 at R1's two
   full shapes within R1's tolerance of the parent's; timed in turns
   (parent, this, this, parent), a call at a time; rows in the redesign
   JSON line;
T2. with every count set to 0: 10 steps from the L1 state with
   ``TargetConfig("cuda", smem_bytes=227 * 1024)``: dist and q must equal
   L3's first 10 steps bitwise, K9 must have launched and K5L not; ms a
   step beside L3's; then
   ``collide_propagate`` under the budget, bitwise equal to the untiled one,
   through K9 alone; 10 steps under the budget from the L1 state in AoS
   and in aosoa4 (bitwise L3's, K9 alone), the LB half-step's graph on
   aosoa4 under the tiled block plan (bitwise untiled), and 3 steps with
   bf16 LB storage under the budget, bitwise 3 untiled bf16 steps (K9's
   policy instance alone), each window counted;
T3. at ``--ludwig-small``, 5 steps on the "cuda" engine under a budget of
   6512 B, which tiles the LB half-step at (1, 1, 2), against 5 untiled
   steps of the "torch" engine, within L5's tolerance;
R1. K10 (the RWKV6 WKV recurrence: a state pass and an output pass, each
   kernel's ptxas report printed) against its plain version
   (``ref.rwkv6_chunked``) at the prefill's shapes, (B, H, T, dk, dv) =
   (4, 64, 2048, 64, 64) with chunk 64, at a batch-1 long prompt (1, 64,
   8192, 64, 64) and at T 100 (chunk 50) with dk = dv = 16, on the
   reference test's inputs (strong decay, random u), on fp32 (BH, T, d)
   tensors and on the model's bf16 (B, H, T, d) views of (B, T, H, d): o
   and the final state within rtol 1e-5, atol 2e-5 x max|plain| (bf16 o
   within one bf16 ulp; the bf16 views' output pass also with o stored in
   fp32, within the fp32 limit); against the scan oracle on a short
   sequence within the reference's 1e-3; timed at both full shapes (fp32,
   bf16 views, each pass alone); the design's own floor logged and put in
   the redesign JSON line;
R2. rwkv6-7b at full width and depth (7,534,813,184 parameters, bf16, drawn
   from seed 0 on the card) prefills B 4 x T 2048 random tokens (cut from
   prefill_32k's (32, 32768), whose bf16 logits alone would take 137 GB):
   with every count set to 0, ``build_prefill`` must launch each of K10's
   two kernels once a layer (32 each); the logits are finite, and their rel-L2 distance from the same
   prefill with the plain WKV (``wkv_engine="torch"``) is at most twice that
   between two plain prefills with chunks of 64 and of 32; on an fp32 copy
   of the weights K10's prefill lies within rel-L2 1e-3 of the plain one;
   prefill timed, and one prefill traced with torch.profiler: its kernels'
   device time (matmuls, K10, the rest) against the host clock;
R3. ``generate`` serves 4 requests: a prompt of 16 tokens fed token by
   token, then 16 greedy tokens; shape and vocab checked, ms a decode step
   beside the weight-read bound; one decode step traced as in R2;
A1. K11 and K12 (GQA flash attention): the ptxas report (registers,
   spills) of their bf16 instances, compiled beside phase 2's build, and
   the library's SASS, where each must hold bf16 HMMA and LDGSTS
   (cp.async) instructions; then against their plain versions
   (``flash_plain``, ``flash_kvchunk_plain``) at starcoder2-7b's heads: K11
   at (BKV, rep, S, dh) = (16, 9, 2048, 128), K12 at (4, 9, 8192, 128),
   causal, in bf16 and fp32, and both at (2, 3, 100, 64) with a window of
   32: fp32 within rtol 1e-5, atol 2e-5 x max|plain|, bf16 within one bf16
   ulp of the output (plus that atol); timed beside the plain version and
   ``scaled_dot_product_attention`` on the same bf16 tensors, with the
   TFLOP/s and share of the bound (QK^T once, p v as two bf16 passes, on
   the tensor cores); where ``build/parent`` holds the parent's tree, its
   flash.cu is built as a library of its own and its bf16 K11/K12 timed in
   turns with this tree's (parent, this, this, parent);
A2. starcoder2-7b at full width and depth (7,172,858,880 parameters, bf16,
   seed 0 on the card) prefills 4 x 2048 tokens (the dense branch) and 1 x
   8192 (the blockwise branch): with every count set to 0 before each, the
   first must launch K11 once a layer (32) and K12 never, the second K12 32
   times and K11 never; logits finite, and within twice the spread of two
   plain-attention prefills that differ only in attention's sum order (the
   dense against the blockwise branch at 2048; kv_block 1024 against 512 at
   8192) of the plain-attention prefill, in bf16 and on an fp32 copy of the
   weights, where they must also lie within rel-L2 1e-3; both timed, the
   4 x 2048 prefill traced as in R2, K11's group named by the bf16
   kernel's symbol, and a group whose kernel launched in the trace must
   read a non-zero time;
A3. ``generate`` serves 4 requests, a 16-token prompt then 16 greedy tokens,
   with a 4096-token cache that every decode step reads whole: ms a step
   beside the bound of reading the weights and the cache once; one decode
   step traced; on the fp32 copy, the decode's logits after the prompt
   within rel-L2 1e-3 of the prefill's at the last prompt position;
6. print the layouts' JSON line, the serving, redesign, mixed-precision,
   V1/RS1, tiled (T1, T2, T4, T5, C1), autotune (U1, U2) and decomposed
   (D1-D3) lines, the
   kernel table of every
   path (the layout instances
   as kernel@layout rows, with Y2's and Y3's launches; the batch instances
   with S2's; K2S and K2's int32 and bf16 instances with RS1's windows; the
   flat chains' policy instances with U2's sweep window) as one JSON line,
   then the result line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import _cuda, tuning  # noqa: E402
from repro_torch.apps.ludwig import LudwigConfig, init_state, step  # noqa: E402
from repro_torch.apps.ludwig import driver as ludwig  # noqa: E402
from repro_torch.apps.ludwig import kernel as lk  # noqa: E402
from repro_torch.apps.milc import MilcConfig, init_problem, residual_check, solve  # noqa: E402
from repro_torch.apps.milc import cg as cg_mod  # noqa: E402
from repro_torch.apps.milc import fields as milc_fields  # noqa: E402
from repro_torch.apps.milc.cg import (batched_cg_active, batched_cg_iteration,  # noqa: E402
                                      batched_cg_state, make_fused_normal, make_wilson_op)
from repro_torch.apps.milc.driver import (make_domain, make_sharded_solver,  # noqa: E402
                                          solve_batched, tune_solve_graphs)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import (SOA, BatchedField, DtypePolicy, Field, TargetConfig,  # noqa: E402
                              parse_layout)
from repro_torch.core.plan import CudaPolicy, LoweringPlan, block_view_ok  # noqa: E402
from repro_torch.core import fuse, plan, reduce, target, tune  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as kf  # noqa: E402
from repro_torch.kernels.lb_collision import collide  # noqa: E402
from repro_torch.kernels.lb_collision import kernel as k7  # noqa: E402
from repro_torch.kernels.lb_propagation import kernel as k8  # noqa: E402
from repro_torch.core.halo import exchange, exchange_padded, fill_padded  # noqa: E402
from repro_torch.core.overlap import overlap_launch, split_boxes  # noqa: E402
from repro_torch.core.stencil import halo_pad  # noqa: E402
from repro_torch.kernels.lb_propagation import propagate, propagate_halo  # noqa: E402
from repro_torch.lattice import Domain  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.kernels.lb_propagation.ops import collide_propagate  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as k10  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref  # noqa: E402
from repro_torch.kernels.wilson_dslash import kernel as wk  # noqa: E402
from repro_torch.launch.serve import SolveRequest, SolveServer  # noqa: E402
from repro_torch.maths import d3q19  # noqa: E402
from repro_torch.models import attention as model_attention  # noqa: E402
from repro_torch.models import init_cache, init_params  # noqa: E402
from repro_torch.train.serve_step import build_prefill, build_serve_step, generate  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, fp32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12  # H100 SXM data sheet, bf16 on the tensor cores (dense)
FIELD_RTOL = 1e-5           # fields: max|kernel - plain| <= FIELD_RTOL * max|plain|
SUM_RTOL = 1e-5             # sums: |kernel - plain| <= SUM_RTOL * sum|terms| per component
KAPPA, HOT, TOL, MAX_ITER = 0.12, 0.6, 1e-10, 2000
LUDWIG_STEPS = 10
MASS_DRIFT = 1e-4            # |mass after - mass before| / mass before
ENGINE_RTOL, ENGINE_ATOL = 1e-4, 1e-6   # Ludwig cuda vs torch engine, 5 steps

KERNELS = [target.G5, target.MUL, target.AXPY, reduce.REDUCE_SUM,
           reduce.REDUCE_MAX, reduce.REDUCE_FOLD, fuse.CG_UPDATE, fuse.CG_XPAY,
           wk.DSLASH, wk.WILSON_NORMAL_T, wk.WILSON_NORMAL_AP, k7.COLLIDE,
           k8.PROPAGATE, k8.LB_STEP, k8.LB_STEP_TILED, lk.CHEM_STRESS, lk.LC_UPDATE,
           lk.FED, k10.WKV, k10.WKV_STATE, kf.FLASH, kf.FLASH_KVCHUNK, fuse.CG_UPDATE_MASKED,
           fuse.CG_XPAY_MASKED, wk.WILSON_NORMAL_T_B, wk.WILSON_NORMAL_AP_B,
           reduce.REDUCE_SUM_B, reduce.REDUCE_MAX_B, reduce.REDUCE_FOLD_B,
           wk.WILSON_NORMAL_T_MIXED, wk.WILSON_NORMAL_AP_MIXED, fuse.CG_UPDATE_AP16,
           fuse.CG_UPDATE_MASKED_AP16, reduce.REDUCE_SUM_C, reduce.REDUCE_FOLD_C,
           k8.LB_STEP_BF16, wk.BF16_ROUND, wk.BF16_PACK, reduce.REDUCE_FOLD_S,
           reduce.REDUCE_FOLD_SB, reduce.REDUCE_FOLD_SC, reduce.REDUCE_SUM_I32,
           reduce.REDUCE_MAX_I32, reduce.REDUCE_FOLD_I32, reduce.REDUCE_SUM_BF16,
           reduce.REDUCE_MAX_BF16, reduce.REDUCE_FOLD_BF16, k8.LB_STEP_TILED_BF16,
           wk.WILSON_NORMAL_T_TILED, wk.WILSON_NORMAL_AP_TILED, wk.WILSON_NORMAL_T_TILED_MIXED,
           wk.WILSON_NORMAL_AP_TILED_MIXED, lk.LC_CHAIN, fuse.CG_UPDATE_POLICY,
           lk.CHEM_STRESS_POLICY, lk.LC_UPDATE_POLICY, wk.DSLASH_HALO, wk.WILSON_NORMAL_PRE_T,
           wk.WILSON_NORMAL_PRE_AP, k8.PROPAGATE_HALO, k8.LB_STEP_PRE, wk.WILSON_NORMAL_BOX_T,
           wk.WILSON_NORMAL_BOX_AP, k8.LB_STEP_BOX, k8.LB_STEP_HALO,
           wk.WILSON_NORMAL_PRE_T_TILED, wk.WILSON_NORMAL_PRE_AP_TILED,
           wk.WILSON_NORMAL_BOX_AP_TILED]

# flops a site, counted from the sources (all these kernels are bound by bytes)
FLOPS = {"collide": 450, "lb_step": 462, "chem_stress": 600, "lc_update": 320, "fed": 160,
         "lc_chain": 440}

# the solve's path: name -> (counters, source, TPU kernel it replaces)
PATH = {
    "g5": ([target.G5], "site_local.cu", "src/repro/core/target.py:387"),
    "mul": ([target.MUL], "site_local.cu", "src/repro/core/target.py:387"),
    "reduce_sum": ([reduce.REDUCE_SUM], "reduce.cu", "src/repro/core/reduce.py:106"),
    "reduce_fold": ([reduce.REDUCE_FOLD], "reduce.cu", "src/repro/core/reduce.py:106"),
    "cg_update": ([fuse.CG_UPDATE], "fused_flat.cu", "src/repro/core/fuse.py:1411"),
    "cg_xpay": ([fuse.CG_XPAY], "fused_flat.cu", "src/repro/core/fuse.py:1411"),
    "dslash": ([wk.DSLASH], "dslash.cu", "src/repro/kernels/wilson_dslash/kernel.py:27"),
    "wilson_normal": ([wk.WILSON_NORMAL_T, wk.WILSON_NORMAL_AP], "wilson_normal.cu",
                      "src/repro/core/fuse.py:1721"),
}

# batched solve serving (S1-S3): the batch instances on solve_batched's path
# (its rhs also runs the single g5 and dslash, and a server's admission the
# single product, sum and fold)
SERVE_PATH = {
    "cg_update_masked": ([fuse.CG_UPDATE_MASKED], "fused_flat.cu",
                         "src/repro/core/fuse.py:1411"),
    "cg_xpay_masked": ([fuse.CG_XPAY_MASKED], "fused_flat.cu", "src/repro/core/fuse.py:1411"),
    "dot_prod": ([target.MUL], "site_local.cu", "src/repro/core/fuse.py:1411"),
    "wilson_normal_batched": ([wk.WILSON_NORMAL_T_B, wk.WILSON_NORMAL_AP_B], "wilson_normal.cu",
                              "src/repro/core/fuse.py:1721"),
    "reduce_sum_batched": ([reduce.REDUCE_SUM_B], "reduce.cu", "src/repro/core/reduce.py:106"),
    "reduce_fold_batched": ([reduce.REDUCE_FOLD_B], "reduce.cu",
                            "src/repro/core/reduce.py:106"),
}
SERVE_SINGLE = ("g5", "dslash")          # PATH's kernels that solve_batched's rhs runs
DRAIN_SINGLE = ("g5", "dslash", "mul", "reduce_sum", "reduce_fold")   # a server's admission
SLOTS, SMALL_SLOTS = 4, 2                # S1-S3's slots at --lattice, S3's at --small
DRAIN_REQUESTS, SMALL_REQUESTS = 6, 3    # S3's requests a bucket
S1_LAYOUT = "aosoa16"                    # S1's layout besides SoA
S1_LIVE, S1_FROZEN = (0, 2), (1, 3)      # S1's mask: slots 0, 2 live (2 all-zero)

# the Ludwig step's path (diagnostics, steps, step_timed): same layout
LUDWIG_PATH = {
    "lb_step": ([k8.LB_STEP], "lb.cu", "src/repro/core/fuse.py:1721"),
    "ludwig_chem_stress": ([lk.CHEM_STRESS], "ludwig_flat.cu", "src/repro/core/fuse.py:1411"),
    "ludwig_lc_update": ([lk.LC_UPDATE], "ludwig_flat.cu", "src/repro/core/fuse.py:1411"),
    "ludwig_fed": ([lk.FED], "ludwig_flat.cu", "src/repro/core/target.py:387"),
    "ludwig_reduce_sum": ([reduce.REDUCE_SUM], "reduce.cu", "src/repro/core/reduce.py:106"),
    "ludwig_reduce_fold": ([reduce.REDUCE_FOLD], "reduce.cu", "src/repro/core/reduce.py:106"),
}

# the paper's unfused-versus-fused LB exhibit (collide, propagate,
# collide_propagate)
LB_EXHIBIT_PATH = {
    "lb_collide": ([k7.COLLIDE], "lb.cu", "src/repro/kernels/lb_collision/kernel.py:30"),
    "lb_propagate": ([k8.PROPAGATE], "lb.cu", "src/repro/kernels/lb_propagation/kernel.py:30"),
    "lb_collide_propagate": ([k8.LB_STEP], "lb.cu", "src/repro/core/fuse.py:1721"),
}

# the Ludwig step under the shared-memory budget (T2), and the fused LB
# half-step under it
SMEM_BUDGET = plan.SMEM_PER_BLOCK_OPTIN   # 227 KiB, the H100's opt-in limit
TILED_PATH = {
    "lb_step_tiled": ([k8.LB_STEP_TILED], "lb_tiled.cu", "src/repro/core/fuse.py:1804"),
}
TILED_EXHIBIT_PATH = {
    "lb_collide_propagate_tiled": ([k8.LB_STEP_TILED], "lb_tiled.cu",
                                   "src/repro/core/fuse.py:1804"),
}
# RWKV6 serving (R1-R3)
RWKV_PATH = {   # K10's two kernels: the state pass and the output pass
    "rwkv6_wkv": ([k10.WKV_STATE, k10.WKV], "rwkv6.cu",
                  "src/repro/kernels/rwkv6_scan/kernel.py:31"),
}
RWKV_PARAMS = 7_534_813_184       # rwkv6-7b, counted from the reference's init
PREFILL_B, PREFILL_T = 4, 2048    # cut from prefill_32k's (32, 32768)
SERVE_B, SERVE_PROMPT, SERVE_NEW = 4, 16, 16
WKV_RTOL, WKV_ATOL_REL = 1e-5, 2e-5   # K10 vs its plain version: rtol, atol / max|plain|
WKV_SCAN_TOL = 1e-3               # chunked vs the scan oracle (tests/test_kernels_rwkv.py)
WKV_LONG = (1, 8192)              # R1's batch-1 long prompt (B, T), BH 64
TF32_TC_FLOP_PER_S = 495e12       # H100 SXM data sheet, TF32 on the tensor cores (dense)
MUFU_PER_S = 16 * 132 * 1.98e9    # exponentials and logarithms: 16 a clock an SM, 132 SMs
# K10's prefill logits against the plain-WKV prefill's.  The random 32-layer
# model amplifies any change of the WKV's fp32 sum order: two plain prefills
# that differ only in the chunk (64 against 32) differ by rel-L2 7.9e-2 in
# bf16 on the card (4.6e-2 at 32 layers, 5.7e-3 at 2 on a width-512 copy of
# the config on the CPU).  So K10 is held to PREFILL_SPREAD x that spread,
# measured in the same run, in bf16 and on an fp32 copy of the weights, and
# in fp32 also to PREFILL_REL_L2_FP32.
PREFILL_SPREAD = 2.0
PREFILL_REL_L2_FP32 = 1e-3

# starcoder2-7b serving (A1-A3)
FLASH_PATH = {
    "flash_attention": ([kf.FLASH], "flash.cu",
                        "src/repro/kernels/flash_attention/kernel.py:47"),
    "flash_attention_kvchunk": ([kf.FLASH_KVCHUNK], "flash.cu",
                                "src/repro/kernels/flash_attention/kernel.py:86"),
}
DENSE_PARAMS = 7_172_858_880      # starcoder2-7b, counted from the reference's init
DENSE_PREFILLS = ((4, 2048), (1, 8192))   # the dense branch, the blockwise branch
DENSE_S_MAX = 4096                # decode_32k's (128, 32768) cut to batch 4 x 4096
FLASH_RTOL, FLASH_ATOL_REL = 1e-5, 2e-5   # fp32; bf16: one bf16 ulp + the atol
FLASH_MMA = "rt_flash_mma_kernel"         # the bf16 instances' kernel (flash.cu)
# A1 times the old design beside the new where a parent tree is unpacked
# there (git archive <parent> | tar -x -C build/parent)
PARENT_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "parent", "src")
DECODE_REL_L2_FP32 = 1e-3         # fp32 decode after the prompt vs the prefill

# mixed precision (P1-P4): the policy instances on the refined solve's path
# (P2; its restarts also run PATH's policy-free wilson_normal), refined
# serving's (P3) and the bf16 LB step's (P4, whose mass is summed compensated)
MIXED_PATH = {
    "wilson_normal_policy": ([wk.WILSON_NORMAL_T_MIXED, wk.WILSON_NORMAL_AP_MIXED],
                             "wilson_normal_mixed.cu", "src/repro/core/fuse.py:1721"),
    "cg_update_ap16": ([fuse.CG_UPDATE_AP16], "fused_flat.cu", "src/repro/core/fuse.py:1411"),
    "reduce_fold_comp": ([reduce.REDUCE_FOLD_C], "reduce.cu", "src/repro/core/reduce.py:106"),
    # the operator's bf16 copy of u (once a solve): the policy launch's stage-in cast
    "bf16_pack": ([wk.BF16_PACK], "fused_flat.cu", "src/repro/core/fuse.py:349"),
}
MIXED_SERVE_PATH = {
    "wilson_normal_batched_policy": ([wk.WILSON_NORMAL_T_MIXED, wk.WILSON_NORMAL_AP_MIXED],
                                     "wilson_normal_mixed.cu", "src/repro/core/fuse.py:1721"),
    "cg_update_masked_ap16": ([fuse.CG_UPDATE_MASKED_AP16], "fused_flat.cu",
                              "src/repro/core/fuse.py:1411"),
    "reduce_fold_comp_batched": ([reduce.REDUCE_FOLD_C], "reduce.cu",
                                 "src/repro/core/reduce.py:106"),
    "bf16_pack_serving": ([wk.BF16_PACK], "fused_flat.cu", "src/repro/core/fuse.py:349"),
}
MIXED_LUDWIG_PATH = {
    "lb_step_bf16": ([k8.LB_STEP_BF16], "lb.cu", "src/repro/core/fuse.py:1721"),
}
# K2's compensated pass 1 runs on no driver path (the refined solve's sums
# are pap's, folded from K5's pairs, and plain norms): its entry point is a
# standalone target_sum under an accumulate policy, P4's mass diagnostic
MIXED_SUM_PATH = {
    "reduce_sum_comp": ([reduce.REDUCE_SUM_C], "reduce.cu", "src/repro/core/reduce.py:106"),
}
BF16 = DtypePolicy(storage="bfloat16", compute="float32", accumulate="float64")
F32 = DtypePolicy(storage="float32", compute="float32", accumulate="float64")
P1_LAYOUTS = ("soa", "aos", "aosoa16")
ORACLE_RTOL = 2.5e-7   # compensated sums: |sum - fp64 sum| <= ORACLE_RTOL sum|terms| + 1e-6
# P3's restart period.  refine_every = 50 (refine_k's default) never restarts
# a solve that converges in 26 iterations: the recurrence then stops at x
# rel-L2 3.9e-3 from full precision and |Mx-b|/|b| 3.3e-3 (the torch engine
# at (8,8,8,8) and (16,16,16,16) on the CPU), outside P2's checks; 10 restarts
# twice and lands at 2.0e-5 and 1.1e-5
P3_REFINE, P3_SERVER_SLOTS = 10, 2
MIXED_REL_X = 1e-4     # P2/P3: x within rel-L2 of the full-precision solve's
# P4: bf16 LB storage against the fp32 steps.  Rounding dist to bf16 each
# step adds velocity noise that the order parameter integrates: q drifts
# linearly, rel-L2 5.5e-3 / 1.1e-2 / 2.7e-2 after 3 / 5 / 10 steps on the CPU
# at (8,8,8) and (32,32,32), in both packages (the port's bf16 steps equal
# the JAX package's, dist bitwise).  So q is held to P4_REL at step 3 (the
# horizon of tests/test_dtype.py), dist to it at step 10, and the cuda
# engine to the torch engine's bf16 steps at --ludwig-small
P4_REL, P4_ENGINE_REL = 1e-2, 1e-3

# the layouts (Y1-Y3): the union of the paper's two Fig. 3 sweeps
# (benchmarks/fig3_kernels.py:108 and :377); Y3's vvls
LAYOUT_SPECS = ("soa", "aos", "aosoa4", "aosoa8", "aosoa16", "aosoa64", "aosoa128")
LAYOUTS = [parse_layout(n) for n in LAYOUT_SPECS]
Y3_VVLS = (32, 64, 128, 256)

# V1: the block view's layouts (SAL dividing every halo'd inner plane)
V1_MILC_LAYOUT, V1_LUDWIG_LAYOUT, V1_MISALIGNED = "aosoa8", "aosoa4", "aosoa16"
# RS1: split reductions.  Each window's kernels, as PATH's: the split solve
# (the solve's path with K2S for the unsplit fold), the split batched solve,
# the split refined solve, and the standalone int32 and bf16 reductions
RSPLIT = 4
RS_FACTORS, RS_SMALL_ROWS = (2, 4, 16), (1, 3)
RS_PATH = {**{n: v for n, v in PATH.items() if n != "reduce_fold"},
           "reduce_fold_split": ([reduce.REDUCE_FOLD_S], "reduce.cu",
                                 "src/repro/core/reduce.py:106")}
RS_BATCH_PATH = {"reduce_fold_split_batched": ([reduce.REDUCE_FOLD_SB], "reduce.cu",
                                               "src/repro/core/fuse.py:209")}
RS_COMP_PATH = {"reduce_fold_split_comp": ([reduce.REDUCE_FOLD_SC], "reduce.cu",
                                           "src/repro/core/fuse.py:209")}
RS_DTYPE_PATH = {
    "reduce_sum_i32": ([reduce.REDUCE_SUM_I32], "reduce.cu", "src/repro/core/reduce.py:106"),
    "reduce_max_i32": ([reduce.REDUCE_MAX_I32], "reduce.cu", "src/repro/core/reduce.py:106"),
    "reduce_fold_i32": ([reduce.REDUCE_FOLD_I32], "reduce.cu", "src/repro/core/reduce.py:106"),
    "reduce_sum_bf16": ([reduce.REDUCE_SUM_BF16], "reduce.cu", "src/repro/core/reduce.py:106"),
    "reduce_max_bf16": ([reduce.REDUCE_MAX_BF16], "reduce.cu", "src/repro/core/reduce.py:106"),
    "reduce_fold_bf16": ([reduce.REDUCE_FOLD_BF16], "reduce.cu",
                         "src/repro/core/reduce.py:106"),
}
RS_WRAP_COMP = 3   # the int32 field's component whose sum passes 2^31

T1_SLICE_TILES = (4, 4, 2)  # tiles a side of the sub-lattice tiled_plain runs on in T1
T3_BUDGET, T3_TILE = 6512, (1, 1, 2)   # T3's budget and the tile it picks
# K9 off SoA and under the bf16 policy (T1, T2): its rows and their windows
T1_LAYOUTS = ("aos", "aosoa4")
T2_BF16_STEPS = 3
TILED_LAYOUT_PATH = {
    **{f"lb_step_tiled@{n}": ([k8.LB_STEP_TILED], "lb_tiled.cu", "src/repro/core/fuse.py:1804")
       for n in T1_LAYOUTS + ("aosoa4/block",)},
    "lb_step_tiled_bf16": ([k8.LB_STEP_TILED_BF16], "lb_tiled.cu", "src/repro/core/fuse.py:1804"),
}
# K5T (T4: the budgeted solve; T5: the budgeted serving and refined solves)
K5T_WALK_TILE = (2, 4, 8)   # T4/T5 also run K5T here: at the budget's tile the walk is linear
NORMAL_TILED_PATH = {
    "wilson_normal_tiled": ([wk.WILSON_NORMAL_T_TILED, wk.WILSON_NORMAL_AP_TILED],
                            "wilson_normal.cu", "src/repro/core/fuse.py:1804"),
}
NORMAL_TILED_POLICY_PATH = {
    "wilson_normal_tiled_policy": ([wk.WILSON_NORMAL_T_TILED_MIXED,
                                    wk.WILSON_NORMAL_AP_TILED_MIXED], "wilson_normal_mixed.cu",
                                   "src/repro/core/fuse.py:1804"),
}
NORMAL_TILED_SERVE_PATH = {
    "wilson_normal_tiled_batched": NORMAL_TILED_PATH["wilson_normal_tiled"],
    **NORMAL_TILED_POLICY_PATH,
}
# K3C, the fused LC chain (the benchmarks' Fig. 3 exhibit), in SoA and AoS
LC_CHAIN_PATH = {n: ([lk.LC_CHAIN], "ludwig_flat.cu", "src/repro/core/fuse.py:1411")
                 for n in ("ludwig_lc_chain", "ludwig_lc_chain@aos")}
LC_CHAIN_RTOL = 1e-6   # K3C against its plain version: max|err| <= LC_CHAIN_RTOL max|plain|
# U1/U2: the flat chains' policy instances (K3, K3L), launched on the
# autotuner's path: its sweep probes and times every graph's dtype twin and
# the accuracy gate's baseline (U2's counted window)
FLAT_POLICY_PATH = {
    "cg_update_policy": ([fuse.CG_UPDATE_POLICY], "fused_flat.cu", "src/repro/core/fuse.py:1411"),
    "ludwig_chem_stress_policy": ([lk.CHEM_STRESS_POLICY], "ludwig_flat.cu",
                                  "src/repro/core/fuse.py:1411"),
    "ludwig_lc_update_policy": ([lk.LC_UPDATE_POLICY], "ludwig_flat.cu",
                                "src/repro/core/fuse.py:1411"),
}
U1_LAYOUTS = ("soa", "aosoa16")
U2_DRAIN_REQUESTS, U2_DRAIN_SLOTS = 3, 2


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median device time of fn() in ms (CUDA events around each call)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def field_err(got, want, name):
    err = (got - want).abs().max().item()
    lim = FIELD_RTOL * want.abs().max().item()
    if not err <= lim:
        raise AssertionError(f"{name}: max abs err {err} > {lim}")
    return err


def exact_err(got, want, name):
    if not torch.equal(got, want):
        raise AssertionError(
            f"{name}: not bitwise equal (max abs err {(got - want).abs().max().item()})")
    return 0.0


def sum_err(got, want, terms, name):
    err = (got - want).abs()
    lim = SUM_RTOL * terms.abs().sum(dim=-1)
    if not bool((err <= lim).all()):
        raise AssertionError(f"{name}: sum err {err.max().item()} beyond {SUM_RTOL} "
                             f"x sum|terms|")
    return err.max().item()


def bound(nbytes: float, flops: float, tc_flops: float = 0.0):
    """The least time (ms) for nbytes moved, flops fp32 operations on the
    CUDA cores and tc_flops bf16 operations on the tensor cores; the two
    kinds of unit run at once, so the operations take the longer of the two."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = max(flops / FP32_FLOP_PER_S, tc_flops / BF16_TC_FLOP_PER_S) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def add_row(rows, name, err, ms, plain_ms, nbytes, flops, tc_flops=0.0, *, library_ms=None):
    """One kernel's measured row: its error against the plain version, its
    time, the plain version's, its bound and the library call's time."""
    b_ms, b_by = bound(nbytes, flops, tc_flops)
    rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                      bound_by=b_by, library_ms=library_ms)
    log(f"  {name:20s} err {err:.3e}  {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"bound {b_ms:.4f} ms ({b_by})"
        + (f"  library {library_ms:.4f} ms" if library_ms is not None else ""))


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def path_counts(path):
    return {name: sum(k.launches for k in ks) for name, (ks, _, _) in path.items()}


def milc_inputs(u, b, vvl):
    """Phase 3's inputs (SoA, the same tensors on every call): the solve's
    b and u, three random spinors and the fold's partial rows."""
    V, dev = b.nsites, b.data.device
    gen = torch.Generator(device=dev).manual_seed(1)
    y, p, ap = (torch.randn((24, V), generator=gen, device=dev) for _ in range(3))
    partials = torch.randn((-(-V // vvl), 24), generator=gen, device=dev)
    alpha = torch.tensor(0.37, device=dev)
    return dict(psi=b.data, u=u.data, y=y, p=p, ap=ap, partials=partials, alpha=alpha,
                neg_alpha=-alpha)


def check_kernels(u, b, lattice, vvl):
    """Phase 3: every kernel against its plain version at the path's shapes."""
    V = math.prod(lattice)
    dev = b.data.device
    inp = milc_inputs(u, b, vvl)
    psi, uu, y, p, ap, alpha, neg_alpha = (
        inp[n] for n in ("psi", "u", "y", "p", "ap", "alpha", "neg_alpha"))
    rows = {}

    def row(*a, **kw):
        add_row(rows, *a, **kw)

    err = exact_err(target.site_g5(psi, 12, vvl), target.g5_plain(psi, 12), "g5")
    sign = torch.ones((24, 1), device=dev)
    sign[12:] = -1.0
    exact_err(torch.mul(psi, sign), target.g5_plain(psi, 12), "g5 as torch.mul by the sign column")
    row("g5", err, time_ms(lambda: target.site_g5(psi, 12, vvl)),
        time_ms(lambda: target.g5_plain(psi, 12)), 2 * 96 * V, 12 * V,
        library_ms=time_ms(lambda: torch.mul(psi, sign)))

    prod = target.site_mul(psi, y, vvl)
    err = exact_err(prod, psi * y, "mul")
    row("mul", err, time_ms(lambda: target.site_mul(psi, y, vvl)),
        time_ms(lambda: psi * y), 3 * 96 * V, 24 * V,
        library_ms=time_ms(lambda: torch.mul(psi, y)))

    err = field_err(target.site_axpy(0.75, psi, y, vvl), psi * 0.75 + y, "axpy")
    log(f"  axpy (not on the solve's path) err {err:.3e}")

    err = sum_err(reduce.reduce_sites(prod, "sum", vvl), reduce.reduce_plain(prod, "sum"),
                  prod, "reduce_sum")
    row("reduce_sum", err, time_ms(lambda: reduce.reduce_sites(prod, "sum", vvl)),
        time_ms(lambda: reduce.reduce_plain(prod, "sum")), 96 * V, 24 * V,
        library_ms=time_ms(lambda: torch.sum(prod, dim=1)))

    exact_err(reduce.reduce_sites(prod, "max", vvl), reduce.reduce_plain(prod, "max"),
              "reduce_max")
    log("  reduce_max (not on the solve's path) bitwise equal")
    tree_err(reduce.reduce_sites(prod, "sum", vvl), reduce.reduce_tree(prod), "reduce_sum")

    partials = inp["partials"]
    err = sum_err(reduce.fold_partials(partials, "sum"), partials.sum(dim=0),
                  partials.T, "reduce_fold")
    row("reduce_fold", err, time_ms(lambda: reduce.fold_partials(partials, "sum")),
        time_ms(lambda: partials.sum(dim=0)), partials.numel() * 4 + 96,
        partials.numel(), library_ms=time_ms(lambda: torch.sum(partials, dim=0)))
    tree_err(reduce.fold_partials(partials, "sum"), reduce.fold_tree(partials), "reduce_fold")

    got = fuse.cg_update(psi, y, p, ap, alpha, neg_alpha, vvl)
    want = fuse.cg_update_plain(psi, y, p, ap, alpha, neg_alpha)
    err = max(field_err(got[0], want[0], "cg_update x_new"),
              field_err(got[1], want[1], "cg_update r_new"),
              sum_err(got[2], want[2], want[1] * want[1], "cg_update rr"))
    row("cg_update", err, time_ms(lambda: fuse.cg_update(psi, y, p, ap, alpha, neg_alpha, vvl)),
        time_ms(lambda: fuse.cg_update_plain(psi, y, p, ap, alpha, neg_alpha)),
        6 * 96 * V, 24 * 6 * V)

    err = field_err(fuse.cg_xpay(p, y, alpha, vvl), fuse.cg_xpay_plain(p, y, alpha), "cg_xpay")
    row("cg_xpay", err, time_ms(lambda: fuse.cg_xpay(p, y, alpha, vvl)),
        time_ms(lambda: fuse.cg_xpay_plain(p, y, alpha)), 3 * 96 * V, 2 * 24 * V,
        library_ms=time_ms(lambda: torch.addcmul(y, alpha, p)))

    err = field_err(wk.dslash_cuda(psi, uu, lattice, vvl), wk.dslash_plain(psi, uu, lattice),
                    "dslash")
    row("dslash", err, time_ms(lambda: wk.dslash_cuda(psi, uu, lattice, vvl)),
        time_ms(lambda: wk.dslash_plain(psi, uu, lattice), reps=3, warm=1),
        (24 + 72 + 24) * 4 * V, 1320 * V)

    got = wk.wilson_normal_cuda(psi, uu, KAPPA, lattice, vvl)
    want = wk.wilson_normal_plain(psi, uu, KAPPA, lattice)
    err = max(field_err(got[0], want[0], "wilson_normal ap"),
              sum_err(got[1], want[1], psi * want[0], "wilson_normal pap"))
    row("wilson_normal", err,
        time_ms(lambda: wk.wilson_normal_cuda(psi, uu, KAPPA, lattice, vvl)),
        time_ms(lambda: wk.wilson_normal_plain(psi, uu, KAPPA, lattice), reps=3, warm=1),
        (24 + 72 + 24) * 4 * V, (2 * (1320 + 48) + 48) * V)
    del got, want, prod, partials, y, p, ap, inp
    torch.cuda.empty_cache()
    return rows


def take_index(lat, lay, device):
    """K8's function as one library call: the flat source offset of each
    physical output of a 19-component field in ``lay``, so that
    ``torch.take(dist, idx)`` is the periodic pull out_i(r) = dist_i(r -
    c_i).  19 V int64 offsets (2.5 GB at (256, 256, 256)), built once,
    outside any timing; the port never calls torch.take."""
    V = math.prod(lat)
    cv = torch.from_numpy(d3q19.CV.astype("int64")).to(device)
    s = torch.arange(V, device=device)
    z, y, x = s % lat[2], s // lat[2] % lat[1], s // (lat[1] * lat[2])
    del s
    src = torch.stack([((x - cv[i, 0]) % lat[0] * lat[1] + (y - cv[i, 1]) % lat[1]) * lat[2]
                       + (z - cv[i, 2]) % lat[2] for i in range(19)])
    del x, y, z
    return lay.pack(lay.flat_index(torch.arange(19, device=device)[:, None], src, 19, V))


def ludwig_inputs(state, vvl):
    """L2's inputs (SoA, the same tensors on every call): the state's q and
    its gradients, dist perturbed off equilibrium and a small force, w, h,
    adv and the fold's partial rows."""
    V, dev = state.q.nsites, state.q.data.device
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(rows, scale):
        return scale * torch.randn((rows, V), generator=gen, device=dev)

    dist = state.dist.canonical() * (1.0 + randn(19, 0.05))
    force = randn(3, 1e-3)
    dq_nd, lapq_nd = ludwig.stage_gradients(state.q.canonical_nd())
    h, w, adv = randn(5, 1e-3), randn(9, 1e-3), randn(5, 1e-4)
    partials = torch.randn((-(-V // vvl), 19), generator=gen, device=dev)
    return dict(dist=dist, force=force, q=state.q.canonical(), dq=dq_nd.reshape(15, V),
                lapq=lapq_nd.reshape(5, V), h=h, w=w, adv=adv, partials=partials)


def check_ludwig_kernels(state, cfg, vvl):
    """L2: every Ludwig kernel against its plain version at the step's
    shapes (:func:`ludwig_inputs`)."""
    lat = cfg.lattice
    V = math.prod(lat)
    inp = ludwig_inputs(state, vvl)
    tau = cfg.tau
    dist, force, q, dq, lapq, h, w, adv = (
        inp[n] for n in ("dist", "force", "q", "dq", "lapq", "h", "w", "adv"))
    rows = {}

    def row(*a, **kw):
        add_row(rows, *a, **kw)

    def slow(fn):
        return time_ms(fn, reps=3, warm=1)

    c = k7.collide_cuda(dist, force, tau, vvl)
    err = exact_err(c, k7.collide_plain(dist, force, tau), "lb_collide")
    row("lb_collide", err, time_ms(lambda: k7.collide_cuda(dist, force, tau, vvl)),
        slow(lambda: k7.collide_plain(dist, force, tau)), 164 * V, FLOPS["collide"] * V)

    p = k8.propagate_cuda(c, lat, vvl)
    err = exact_err(p, k8.propagate_plain(c, lat), "lb_propagate")
    idx = take_index(lat, SOA, c.device)
    exact_err(torch.take(c, idx), p, "torch.take against lb_propagate")
    row("lb_propagate", err, time_ms(lambda: k8.propagate_cuda(c, lat, vvl)),
        slow(lambda: k8.propagate_plain(c, lat)), 152 * V, 0,
        library_ms=time_ms(lambda: torch.take(c, idx)))
    del idx

    d2, u = k8.lb_step_cuda(dist, force, tau, lat, vvl)
    want2, want_u = k8.lb_step_plain(dist, force, tau, lat)
    err = max(exact_err(d2, want2, "lb_step dist2"), field_err(u, want_u, "lb_step u"))
    exact_err(d2, p, "lb_step dist2 against propagate(collide)")
    row("lb_step", err, time_ms(lambda: k8.lb_step_cuda(dist, force, tau, lat, vvl)),
        slow(lambda: k8.lb_step_plain(dist, force, tau, lat)), 176 * V,
        FLOPS["lb_step"] * V)

    d3, _ = k8.lb_step_cuda(dist, force, tau, lat, vvl, with_u=False)
    err = exact_err(d3, want2, "lb_collide_propagate")
    exact_err(d3, d2, "lb_collide_propagate against lb_step")
    row("lb_collide_propagate", err,
        time_ms(lambda: k8.lb_step_cuda(dist, force, tau, lat, vvl, with_u=False)),
        slow(lambda: k8.lb_step_plain(dist, force, tau, lat, with_u=False)), 164 * V,
        FLOPS["collide"] * V)
    del c, p, d2, u, want2, want_u, d3

    kw = dict(a0=cfg.a0, gamma=cfg.gamma, kappa_m=cfg.kappa, kappa_s=cfg.kappa, xi=cfg.xi)
    got = lk.chem_stress_cuda(q, lapq, dq, vvl=vvl, **kw)
    want = lk.chem_stress_plain(q, lapq, dq, **kw)
    err = max(field_err(got[0], want[0], "chem_stress h"),
              field_err(got[1], want[1], "chem_stress sigma"))
    row("ludwig_chem_stress", err, time_ms(lambda: lk.chem_stress_cuda(q, lapq, dq, vvl=vvl, **kw)),
        slow(lambda: lk.chem_stress_plain(q, lapq, dq, **kw)), 156 * V,
        FLOPS["chem_stress"] * V)

    kw = dict(gamma_rot=cfg.gamma_rot, xi=cfg.xi, dt=cfg.dt)
    err = field_err(lk.lc_update_cuda(q, h, w, adv, vvl=vvl, **kw),
                    lk.lc_update_plain(q, h, w, adv, **kw), "lc_update")
    row("ludwig_lc_update", err, time_ms(lambda: lk.lc_update_cuda(q, h, w, adv, vvl=vvl, **kw)),
        slow(lambda: lk.lc_update_plain(q, h, w, adv, **kw)), 116 * V,
        FLOPS["lc_update"] * V)

    kw = dict(a0=cfg.a0, gamma=cfg.gamma, kappa=cfg.kappa)
    err = field_err(lk.fed_cuda(q, dq, vvl=vvl, **kw), lk.fed_plain(q, dq, **kw), "fed")
    row("ludwig_fed", err, time_ms(lambda: lk.fed_cuda(q, dq, vvl=vvl, **kw)),
        slow(lambda: lk.fed_plain(q, dq, **kw)), 84 * V, FLOPS["fed"] * V)

    err = sum_err(reduce.reduce_sites(dist, "sum", vvl), reduce.reduce_plain(dist, "sum"),
                  dist, "reduce_sum of dist")
    row("ludwig_reduce_sum", err, time_ms(lambda: reduce.reduce_sites(dist, "sum", vvl)),
        time_ms(lambda: reduce.reduce_plain(dist, "sum")), 76 * V, 19 * V,
        library_ms=time_ms(lambda: torch.sum(dist, dim=1)))
    tree_err(reduce.reduce_sites(dist, "sum", vvl), reduce.reduce_tree(dist), "ludwig_reduce_sum")

    partials = inp["partials"]
    err = sum_err(reduce.fold_partials(partials, "sum"), partials.sum(dim=0),
                  partials.T, "reduce_fold of the dist partials")
    row("ludwig_reduce_fold", err, time_ms(lambda: reduce.fold_partials(partials, "sum")),
        time_ms(lambda: partials.sum(dim=0)), partials.numel() * 4 + 76,
        partials.numel(), library_ms=time_ms(lambda: torch.sum(partials, dim=0)))
    tree_err(reduce.fold_partials(partials, "sum"), reduce.fold_tree(partials),
             "ludwig_reduce_fold")
    del dist, force, dq, lapq, h, w, adv, got, want, partials, inp
    torch.cuda.empty_cache()
    return rows


def run_ludwig(state, cfg):
    """L3: diagnostics, LUDWIG_STEPS steps and one step_timed on the cuda
    engine, diagnostics again; returns the state after the LUDWIG_STEPS
    steps, the last state and the path's launch counts."""
    reset_counts()
    d0 = ludwig.diagnostics(state, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = state
    for _ in range(LUDWIG_STEPS):
        s = step(s, cfg)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / LUDWIG_STEPS
    after_steps = s
    s, stages = ludwig.step_timed(s, cfg)
    d1 = ludwig.diagnostics(s, cfg)
    counts = path_counts(LUDWIG_PATH)
    m0, m1 = float(d0["mass"]), float(d1["mass"])
    fe0, fe1 = float(d0["free_energy"]), float(d1["free_energy"])
    log(f"ludwig {cfg.lattice} on {cfg.target.engine}: {step_s * 1e3:.3f} ms/step over {LUDWIG_STEPS} "
        f"steps; mass {m0!r} -> {m1!r} (drift {abs(m1 - m0) / m0:.3e}), free energy "
        f"{fe0!r} -> {fe1!r}, momentum {d1['momentum'].tolist()}")
    total = sum(stages.values())
    log("step_timed (ms): " + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in stages.items())
        + f"; sum {total * 1e3:.3f}")
    log(f"launches on the step's path: {counts}")
    log(f"max memory allocated: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, t in (("q", s.q.data), ("dist", s.dist.data)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"ludwig {name} has non-finite values")
    for k, v in list(d0.items()) + list(d1.items()):
        if not torch.isfinite(v).all():
            raise AssertionError(f"ludwig diagnostic {k} is not finite")
    if not abs(m1 - m0) / m0 < MASS_DRIFT:
        raise AssertionError(f"mass drifted from {m0} to {m1}")
    if not fe1 <= fe0:
        raise AssertionError(f"free energy rose from {fe0} to {fe1}")
    idle = [n for n, c in counts.items() if c == 0]
    if idle:
        raise AssertionError(f"kernels of the step's path never launched: {idle}")
    return after_steps, s, counts, step_s * 1e3


def lb_exhibit(state, cfg):
    """L4: propagate(collide(d, f)) against collide_propagate(d, f) through
    the public entry points on the cuda engine."""
    reset_counts()
    V = math.prod(cfg.lattice)
    gen = torch.Generator(device=state.dist.data.device).manual_seed(3)
    force = Field.from_canonical(
        "force", 1e-3 * torch.randn((3, V), generator=gen, device=state.dist.data.device),
        cfg.lattice)
    d, tgt, tau = state.dist, cfg.target, cfg.tau
    unfused = propagate(collide(d, force, tau=tau, config=tgt), config=tgt)
    fused = collide_propagate(d, force, tau=tau, config=tgt)
    exact_err(fused.data, unfused.data, "collide_propagate against propagate(collide)")
    t_unfused = time_ms(lambda: propagate(collide(d, force, tau=tau, config=tgt), config=tgt))
    t_fused = time_ms(lambda: collide_propagate(d, force, tau=tau, config=tgt))
    counts = path_counts(LB_EXHIBIT_PATH)
    log(f"LB half-step {cfg.lattice}: unfused propagate(collide) {t_unfused:.4f} ms, fused "
        f"collide_propagate {t_fused:.4f} ms, dist2 bitwise equal; launches {counts}")
    idle = [n for n, c in counts.items() if c == 0]
    if idle:
        raise AssertionError(f"kernels of the LB exhibit never launched: {idle}")
    return counts


def ludwig_engines(small):
    """L5: 5 steps on the cuda and the torch engine, both on the card."""
    cfgs = [LudwigConfig(lattice=small, target=TargetConfig(e, device="cuda"))
            for e in ("cuda", "torch")]
    states = [init_state(c, seed=0) for c in cfgs]
    for _ in range(5):
        states = [step(s, c) for s, c in zip(states, cfgs)]
    (sc, st) = states
    for name, a, b in (("q", sc.q.data, st.q.data), ("dist", sc.dist.data, st.dist.data)):
        err = (a - b).abs().max().item()
        log(f"ludwig {small}, 5 steps: {name} cuda vs torch engine max abs diff {err:.3e}")
        if not torch.allclose(a, b, rtol=ENGINE_RTOL, atol=ENGINE_ATOL):
            raise AssertionError(f"ludwig cuda and torch engines disagree on {name}")


# -- the layouts (Y1-Y3) ------------------------------------------------------------

def site_dims(lay):
    """The site axes of a physical tensor in ``lay`` (what a per-component
    sum folds)."""
    return {"soa": (1,), "aos": (0,)}.get(lay.name, (0, 2))


def comp_column(lay, col):
    """A (ncomp, 1) column as a tensor that broadcasts against ``lay``'s
    physical shape."""
    n = col.shape[0]
    return {"soa": col, "aos": col.reshape(1, n)}.get(lay.name, col.reshape(1, n, 1))


def milc_layout_cases(inp, lattice, vvl):
    """Y1's MILC kernels: name -> (kernel, plain, library or None, bytes,
    flops), each a function of the inputs packed in a layout and that
    layout; kernel and plain return [(kind, physical or sum tensor, terms)]
    with kind "field", "exact" (a field compared bitwise) or "sum"."""
    V = math.prod(lattice)
    a = inp["alpha"]
    sign = torch.ones((24, 1), device=inp["psi"].device)
    sign[12:] = -1.0

    def L(lay, *names):
        return {n: lay for n in names}

    # a sum's terms are a function, evaluated for the error check alone
    def cg(fn):
        return lambda t, lay: (lambda o: [("field", o[0], None), ("field", o[1], None),
                                          ("sum", o[2], lambda: lay.unpack(o[1]) ** 2)])(
            fn(t["psi"], t["y"], t["p"], t["ap"], a, t["neg_alpha"],
               layouts=L(lay, "x", "r", "p", "ap")))

    def normal(fn):
        return lambda t, lay: (lambda o: [
            ("field", o[0], None),
            ("sum", o[1], lambda: lay.unpack(t["psi"]) * lay.unpack(o[0]))])(
            fn(t["psi"], t["u"], KAPPA, lattice, layouts=L(lay, "p", "u")))

    return {
        "g5": (lambda t, lay: [("exact", target.site_g5(t["psi"], 12, vvl, layouts=L(lay, "x")),
                                None)],
               lambda t, lay: [("exact", target.g5_plain(t["psi"], 12, L(lay, "x")), None)],
               lambda t, lay: torch.mul(t["psi"], comp_column(lay, sign)), 2 * 96 * V, 12 * V),
        "mul": (lambda t, lay: [("exact", target.site_mul(t["psi"], t["y"], vvl,
                                                          layouts=L(lay, "x", "y")), None)],
                lambda t, lay: [("exact", t["psi"] * t["y"], None)],
                lambda t, lay: torch.mul(t["psi"], t["y"]), 3 * 96 * V, 24 * V),
        "reduce_sum": (lambda t, lay: [("sum", reduce.reduce_sites(t["prod"], "sum", vvl,
                                                                   layouts=L(lay, "x")),
                                        lambda: lay.unpack(t["prod"]))],
                       lambda t, lay: [("sum", reduce.reduce_plain(lay.unpack(t["prod"]), "sum"),
                                        None)],
                       lambda t, lay: torch.sum(t["prod"], dim=site_dims(lay)), 96 * V, 24 * V),
        "reduce_fold": (lambda t, lay: [("sum", reduce.fold_partials(t["partials"], "sum"),
                                         lambda: t["partials"].T)],
                        lambda t, lay: [("sum", t["partials"].sum(dim=0), None)],
                        lambda t, lay: torch.sum(t["partials"], dim=0),
                        inp["partials"].numel() * 4 + 96, inp["partials"].numel()),
        "cg_update": (cg(lambda *x, layouts: fuse.cg_update(*x, vvl, layouts=layouts)),
                      cg(fuse.cg_update_plain), None, 6 * 96 * V, 24 * 6 * V),
        "cg_xpay": (lambda t, lay: [("field", fuse.cg_xpay(t["p"], t["y"], a, vvl,
                                                           layouts=L(lay, "x", "y")), None)],
                    lambda t, lay: [("field", fuse.cg_xpay_plain(t["p"], t["y"], a,
                                                                 L(lay, "x", "y")), None)],
                    lambda t, lay: torch.addcmul(t["y"], a, t["p"]), 3 * 96 * V, 2 * 24 * V),
        "dslash": (lambda t, lay: [("field", wk.dslash_cuda(t["psi"], t["u"], lattice, vvl,
                                                            layouts=L(lay, "psi", "u")), None)],
                   lambda t, lay: [("field", wk.dslash_plain(t["psi"], t["u"], lattice,
                                                             L(lay, "psi", "u")), None)],
                   None, (24 + 72 + 24) * 4 * V, 1320 * V),
        "wilson_normal": (normal(lambda *x, layouts: wk.wilson_normal_cuda(*x, vvl,
                                                                           layouts=layouts)),
                          normal(wk.wilson_normal_plain), None, (24 + 72 + 24) * 4 * V,
                          (2 * (1320 + 48) + 48) * V),
    }


def ludwig_layout_cases(inp, cfg, vvl):
    """Y1's Ludwig kernels, as :func:`milc_layout_cases`."""
    lat, tau = cfg.lattice, cfg.tau
    V = math.prod(lat)
    lc = dict(a0=cfg.a0, gamma=cfg.gamma, kappa_m=cfg.kappa, kappa_s=cfg.kappa, xi=cfg.xi)
    lu = dict(gamma_rot=cfg.gamma_rot, xi=cfg.xi, dt=cfg.dt)
    fe = dict(a0=cfg.a0, gamma=cfg.gamma, kappa=cfg.kappa)

    def L(lay, *names):
        return {n: lay for n in names}

    def fields(*kinds):
        return lambda o: [(k, x, None) for k, x in zip(kinds, o if isinstance(o, tuple) else (o,))
                          if x is not None]

    def step(with_u, fn, kinds, **kw):
        return lambda t, lay: fields(*kinds)(
            fn(t["dist"], t["force"], tau, lat, with_u=with_u,
               layouts=L(lay, "dist", "force"), **kw))

    return {
        "lb_collide": (lambda t, lay: fields("exact")(k7.collide_cuda(
                           t["dist"], t["force"], tau, vvl, layouts=L(lay, "dist", "force"))),
                       lambda t, lay: fields("exact")(k7.collide_plain(
                           t["dist"], t["force"], tau, L(lay, "dist", "force"))),
                       None, 164 * V, FLOPS["collide"] * V),
        "lb_propagate": (lambda t, lay: fields("exact")(k8.propagate_cuda(
                             t["collided"], lat, vvl, layouts=L(lay, "dist"))),
                         lambda t, lay: fields("exact")(k8.propagate_plain(
                             t["collided"], lat, L(lay, "dist"))),
                         lambda t, lay: torch.take(t["collided"], t["take_idx"]), 152 * V, 0),
        "lb_step": (step(True, k8.lb_step_cuda, ("exact", "field"), vvl=vvl),
                    step(True, k8.lb_step_plain, ("exact", "field")), None,
                    176 * V, FLOPS["lb_step"] * V),
        "lb_collide_propagate": (step(False, k8.lb_step_cuda, ("exact",), vvl=vvl),
                                 step(False, k8.lb_step_plain, ("exact",)), None, 164 * V,
                                 FLOPS["collide"] * V),
        "ludwig_chem_stress": (
            lambda t, lay: fields("field", "field")(lk.chem_stress_cuda(
                t["q"], t["lapq"], t["dq"], vvl=vvl, layouts=L(lay, "q", "lapq", "dq"), **lc)),
            lambda t, lay: fields("field", "field")(lk.chem_stress_plain(
                t["q"], t["lapq"], t["dq"], layouts=L(lay, "q", "lapq", "dq"), **lc)),
            None, 156 * V, FLOPS["chem_stress"] * V),
        "ludwig_lc_update": (
            lambda t, lay: fields("field")(lk.lc_update_cuda(
                t["q"], t["h"], t["w"], t["adv"], vvl=vvl, layouts=L(lay, "q", "h", "w", "adv"),
                **lu)),
            lambda t, lay: fields("field")(lk.lc_update_plain(
                t["q"], t["h"], t["w"], t["adv"], layouts=L(lay, "q", "h", "w", "adv"), **lu)),
            None, 116 * V, FLOPS["lc_update"] * V),
        "ludwig_fed": (lambda t, lay: fields("field")(lk.fed_cuda(
                           t["q"], t["dq"], vvl=vvl, layouts=L(lay, "q", "dq"), **fe)),
                       lambda t, lay: fields("field")(lk.fed_plain(
                           t["q"], t["dq"], layouts=L(lay, "q", "dq"), **fe)),
                       None, 84 * V, FLOPS["fed"] * V),
        "ludwig_reduce_sum": (lambda t, lay: [("sum", reduce.reduce_sites(
                                  t["dist"], "sum", vvl, layouts=L(lay, "x")),
                                  lambda: lay.unpack(t["dist"]))],
                              lambda t, lay: [("sum", reduce.reduce_plain(
                                  lay.unpack(t["dist"]), "sum"), None)],
                              lambda t, lay: torch.sum(t["dist"], dim=site_dims(lay)), 76 * V,
                              19 * V),
        "ludwig_reduce_fold": (lambda t, lay: [("sum", reduce.fold_partials(t["partials"], "sum"),
                                                lambda: t["partials"].T)],
                               lambda t, lay: [("sum", t["partials"].sum(dim=0), None)],
                               lambda t, lay: torch.sum(t["partials"], dim=0),
                               inp["partials"].numel() * 4 + 76, inp["partials"].numel()),
    }


def run_layout_cases(cases, inp, packed_extra, layouts):
    """Y1 for one path: every case in every layout.  A case's outputs must
    equal its SoA launch's bitwise (fields unpacked, sums as they are) and
    its plain version in the same layout within the stated tolerance.
    Returns {layout name: {case: row}} with each row's error against the
    plain version, its time, the plain version's and the library call's
    (CUDA events, median of 10 and of 3), bound and ratio to SoA."""
    out, soa = {}, {}
    for lay in layouts:
        t = {n: (v if n == "partials" or v.dim() == 0 else lay.pack(v)) for n, v in inp.items()}
        t.update({n: fn(t, lay) for n, fn in packed_extra.items()})
        rows = {}
        for name, (kern, plain, library, nbytes, flops) in cases.items():
            got, want = kern(t, lay), plain(t, lay)
            err = 0.0
            for i, ((kind, g, terms), (_, w, _)) in enumerate(zip(got, want)):
                what = f"Y1 {name}[{i}] in {lay.name}"
                canon = g if kind == "sum" else lay.unpack(g)
                if lay.name == "soa":
                    soa[(name, i)] = canon
                else:
                    exact_err(canon, soa[(name, i)], f"{what} against its SoA launch")
                if kind == "sum":
                    err = max(err, sum_err(g, w, terms(), f"{what} against the plain version"))
                elif kind == "exact":
                    err = max(err, exact_err(g, w, f"{what} against the plain version"))
                else:
                    err = max(err, field_err(lay.unpack(g), lay.unpack(w),
                                             f"{what} against the plain version"))
            del got, want
            b_ms, b_by = bound(nbytes, flops)
            rows[name] = dict(max_abs_err=err, ms=time_ms(lambda: kern(t, lay)),
                              plain_ms=time_ms(lambda: plain(t, lay), reps=3, warm=1),
                              bound_ms=b_ms, bound_by=b_by,
                              library_ms=(time_ms(lambda: library(t, lay))
                                          if library is not None else None))
        del t
        torch.cuda.empty_cache()
        for name, r in rows.items():
            r["ratio_to_soa"] = r["ms"] / (out["soa"][name]["ms"] if out else r["ms"])
        out[lay.name] = rows
        log(f"  {lay.name:9s} " + ", ".join(f"{n} {r['ms']:.4f} ms ({r['ratio_to_soa']:.2f}x)"
                                            for n, r in rows.items()))
    return out


def check_layout_kernels(u, b, lattice, state, lcfg, vvl):
    """Y1: every lattice kernel of both paths in every layout of LAYOUTS at
    the full lattices, on phase 3's and L2's inputs repacked on the card."""
    log(f"Y1: MILC kernels at {lattice}, vvl {vvl}, layouts {LAYOUT_SPECS}:")
    inp = milc_inputs(u, b, vvl)
    milc = run_layout_cases(
        milc_layout_cases(inp, lattice, vvl), inp,
        {"prod": lambda t, lay: t["psi"] * t["y"]}, LAYOUTS)
    del inp
    log(f"Y1: Ludwig kernels at {lcfg.lattice}, vvl {vvl}:")
    inp = ludwig_inputs(state, vvl)
    lud = run_layout_cases(
        ludwig_layout_cases(inp, lcfg, vvl), inp,
        {"collided": lambda t, lay: k7.collide_cuda(t["dist"], t["force"], lcfg.tau, vvl,
                                                    layouts={"dist": lay, "force": lay}),
         "take_idx": lambda t, lay: take_index(lcfg.lattice, lay, t["dist"].device)},
        LAYOUTS)
    del inp
    torch.cuda.empty_cache()
    return {name: {**milc[name], **lud[name]} for name in milc}


def solve_layouts(cfg, u, b, x_soa, iterations):
    """Y2: the MILC solve from phase 2's u and b repacked, in every layout
    (SoA again, so that every layout's ms an iteration is taken in the same
    phase): phase 4's iteration count, x bitwise equal to phase 4's,
    residual_check < 1e-3, every kernel of the path launched; returns
    {layout name: (counts, ms an iteration)}."""
    out = {}
    for lay in LAYOUTS:
        lcfg = dataclasses.replace(cfg, layout=lay)
        ul, bl = u.as_layout(lay), b.as_layout(lay)
        reset_counts()
        res, solve_s = solve_timed(lcfg, ul, bl)
        rc = residual_check(lcfg, ul, bl, res.x)
        counts = path_counts(PATH)
        ms_it = solve_s / max(res.iterations, 1) * 1e3
        log(f"Y2: solve {cfg.lattice} in {lay.name}: {res.iterations} iterations, {solve_s:.3f} s, "
            f"{ms_it:.3f} ms/iter, |Mx-b|/|b| = {rc:.3e}; launches {counts}")
        if res.iterations != iterations:
            raise AssertionError(f"Y2 {lay.name}: {res.iterations} iterations, SoA took "
                                 f"{iterations}")
        if res.x.layout != lay:
            raise AssertionError(f"Y2 {lay.name}: x came back in {res.x.layout.name}")
        exact_err(res.x.canonical(), x_soa, f"Y2 {lay.name}: x against the SoA solve's")
        if not rc < 1e-3:
            raise AssertionError(f"Y2 {lay.name}: residual_check {rc} >= 1e-3")
        idle = [n for n, c in counts.items() if c == 0]
        if idle:
            raise AssertionError(f"Y2 {lay.name}: kernels of the path never launched: {idle}")
        out[lay.name] = (counts, ms_it)
        del ul, bl, res
        torch.cuda.empty_cache()
    return out


def ludwig_layouts(state, after_steps, cfg):
    """Y3: LUDWIG_STEPS steps from the L1 state repacked, in every layout of
    LAYOUTS and at every vvl of Y3_VVLS its SAL divides, bitwise equal to
    L3's; then, at the default vvl, diagnostics equal to SoA's and the LB
    exhibit (L4) bitwise equal to its own fused launch and timed (after its
    counts are read), and one ``step_timed``.  Returns ({layout: {vvl: ms a
    step}}, {layout: step-path counts}, {layout: exhibit counts}, {layout:
    step_timed's stages in ms}, {layout: {"unfused", "fused": exhibit
    ms}})."""
    grid, counts, xcounts, stages, exhibit = {}, {}, {}, {}, {}
    d_soa = ludwig.diagnostics(state, cfg)
    V = math.prod(cfg.lattice)
    gen = torch.Generator(device=state.dist.data.device).manual_seed(3)
    force = 1e-3 * torch.randn((3, V), generator=gen, device=state.dist.data.device)
    for lay in LAYOUTS:
        s0 = ludwig.LudwigState(dist=state.dist.as_layout(lay), q=state.q.as_layout(lay))
        grid[lay.name] = {}
        for vvl in Y3_VVLS:
            if vvl % lay.sal:
                continue
            lcfg = dataclasses.replace(cfg, layout=lay,
                                       target=dataclasses.replace(cfg.target, vvl=vvl))
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = s0
            for _ in range(LUDWIG_STEPS):
                s = step(s, lcfg)
            torch.cuda.synchronize()
            grid[lay.name][vvl] = (time.perf_counter() - t0) / LUDWIG_STEPS * 1e3
            what = f"Y3 {lay.name} vvl {vvl}"
            if (s.dist.layout, s.q.layout) != (lay, lay):
                raise AssertionError(f"{what}: the state left its layout")
            exact_err(s.dist.canonical(), after_steps.dist.data, f"{what}: dist against L3's")
            exact_err(s.q.canonical(), after_steps.q.data, f"{what}: q against L3's")
            if vvl != cfg.target.vvl:
                continue
            # the stage breakdown of one more step in this layout
            _, stages[lay.name] = ludwig.step_timed(s, lcfg)
            d = ludwig.diagnostics(s0, lcfg)
            for k, v in d.items():
                exact_err(v, d_soa[k], f"{what}: diagnostics {k} against SoA's")
            counts[lay.name] = path_counts(LUDWIG_PATH)
            reset_counts()
            fl = Field.from_canonical("force", force, cfg.lattice, lay)
            tgt = lcfg.target
            unfused = propagate(collide(s0.dist, fl, tau=cfg.tau, config=tgt), config=tgt)
            fused = collide_propagate(s0.dist, fl, tau=cfg.tau, config=tgt)
            exact_err(fused.canonical(), unfused.canonical(),
                      f"{what}: collide_propagate against propagate(collide)")
            xcounts[lay.name] = path_counts(LB_EXHIBIT_PATH)
            idle = [n for c in (counts[lay.name], xcounts[lay.name]) for n, k in c.items()
                    if k == 0]
            if idle:
                raise AssertionError(f"{what}: kernels of the path never launched: {idle}")
            exhibit[lay.name] = {
                "unfused": time_ms(lambda: propagate(collide(s0.dist, fl, tau=cfg.tau, config=tgt),
                                                     config=tgt)),
                "fused": time_ms(lambda: collide_propagate(s0.dist, fl, tau=cfg.tau, config=tgt))}
            del unfused, fused, fl, d
        stages[lay.name] = {k: v * 1e3 for k, v in stages[lay.name].items()}
        log(f"Y3: ludwig {cfg.lattice} in {lay.name}: ms/step " + ", ".join(
            f"vvl {v} {ms:.3f}" for v, ms in grid[lay.name].items())
            + f"; dist and q bitwise L3's; launches {counts[lay.name]}, exhibit "
            f"{xcounts[lay.name]} (unfused {exhibit[lay.name]['unfused']:.4f} ms, fused "
            f"{exhibit[lay.name]['fused']:.4f} ms); step_timed (ms) " + ", ".join(
                f"{k} {v:.3f}" for k, v in stages[lay.name].items()))
        del s0, s
        torch.cuda.empty_cache()
    return grid, counts, xcounts, stages, exhibit


def lb_smem_views(cfg):
    """The LB half-step's footprint descriptor, as LaunchGraph.launch
    builds it: (ncomp, ring, itemsize) of dist and force, (ncomp, itemsize)
    of dist2 and u."""
    rings = ludwig.lb_step_graph(cfg).halo_widths(("dist2", "u"))
    return (((19, rings["dist"], 4), (3, rings["force"], 4)), ((19, 4), (3, 4)))


def k9_blocks_per_sm(ptxas, dev, block):
    """(registers a thread, blocks of ``block`` threads an SM) of K9 from
    its ptxas report: the register file, allocated 256 registers a warp at
    a time, and the SM's threads bound it; K9 declares no shared memory."""
    regs, entry = None, False
    for ln in ptxas:
        if "Compiling entry" in ln:
            entry = "lb_tiled_kernelILi0ELb0E" in ln   # the SoA fp32 instantiation
        elif entry and "Used" in ln:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            break
    if regs is None:
        raise AssertionError("the ptxas report has no registers of K9's kernel")
    props = torch.cuda.get_device_properties(dev)
    per_warp = -(-regs * 32 // 256) * 256
    warps = props.regs_per_multiprocessor // per_warp
    return regs, min(warps // (block // 32), props.max_threads_per_multi_processor // block)


def check_tiled_kernel(state, cfg, vvl, ptxas):
    """T1: the budget's plan, K9's blocks an SM, K9 against K5L bitwise and
    against the plain LB step on the whole lattice, timed beside K5L, and
    K9 against tiled_plain on a slice."""
    lat = cfg.lattice
    V = math.prod(lat)
    dev = state.dist.data.device
    budget_cfg = dataclasses.replace(cfg.target, smem_bytes=SMEM_BUDGET)
    views = lb_smem_views(cfg)
    p = plan.default_plan(budget_cfg, nsites=V, layouts=[SOA], stencil=True, lattice=lat,
                          smem_views=views)
    tile = (p.bx, p.by, p.bz)
    optin = _cuda.smem_per_block_optin(dev)
    log(f"T1: budget {SMEM_BUDGET} B -> plan {p.describe()} (model "
        f"{plan.estimate_smem_bytes(p, lattice=lat, in_views=views[0], out_views=views[1])} B); "
        f"per-block opt-in limit {plan.SMEM_PER_BLOCK_OPTIN} B planned for, {optin} B on the "
        f"card")
    if lat == (256, 256, 256) and tile != (1, 4, 64):
        raise AssertionError(f"expected the tile (1, 4, 64) at {lat}, got {tile}")
    if not p.tiled:
        raise AssertionError(f"plan {p} is not a tiled plan")

    gen = torch.Generator(device=dev).manual_seed(4)
    dist = state.dist.data * (1.0 + 0.05 * torch.randn((19, V), generator=gen, device=dev))
    force = 1e-3 * torch.randn((3, V), generator=gen, device=dev)
    tau = cfg.tau
    d5, u5 = k8.lb_step_cuda(dist, force, tau, lat, vvl)
    d9, u9 = k8.lb_step_tiled_cuda(dist, force, tau, lat, tile)
    exact_err(d9, d5, "K9 lb_step dist2 against K5L")
    exact_err(u9, u5, "K9 lb_step u against K5L")
    c9, _ = k8.lb_step_tiled_cuda(dist, force, tau, lat, tile, with_u=False)
    exact_err(c9, d5, "K9 lb_collide_propagate against K5L")
    regs, per_sm = k9_blocks_per_sm(ptxas, dev, k8.K9_BLOCK)
    log(f"  K9: no shared memory, {regs} registers a thread (ptxas), {per_sm} blocks of "
        f"{k8.K9_BLOCK} threads an SM; bitwise K5L")
    del d5, u5
    want2, want_u = k8.lb_step_plain(dist, force, tau, lat)
    err = max(field_err(d9, want2, "K9 lb_step dist2 against lb_step_plain"),
              field_err(u9, want_u, "K9 lb_step u against lb_step_plain"))
    err_cp = field_err(c9, want2, "K9 lb_collide_propagate against lb_step_plain")
    del c9, u9, want2, want_u
    plain_ms = time_ms(lambda: k8.lb_step_plain(dist, force, tau, lat), reps=3, warm=1)
    plain_cp_ms = time_ms(lambda: k8.lb_step_plain(dist, force, tau, lat, with_u=False),
                          reps=3, warm=1)

    # tiled_plain runs tile by tile in torch ops: a slice of the lattice, a
    # periodic lattice of its own
    slat = tuple(min(n, k * e) for n, k, e in
                 zip(lat, T1_SLICE_TILES, plan.tile_extents(lat, *tile)))
    sl = (slice(None),) + tuple(slice(0, n) for n in slat)
    ds = dist.reshape((19,) + lat)[sl].reshape(19, -1).contiguous()
    fs = force.reshape((3,) + lat)[sl].reshape(3, -1).contiguous()
    got2, got_u = k8.lb_step_tiled_cuda(ds, fs, tau, slat, tile)
    want2, want_u = k8.lb_step_tiled_plain(ds, fs, tau, slat, tile)
    slice_err = max(field_err(got2, want2, "K9 dist2 against tiled_plain"),
                    field_err(got_u, want_u, "K9 u against tiled_plain"))
    tp_ms = time_ms(lambda: k8.lb_step_tiled_plain(ds, fs, tau, slat, tile), reps=3, warm=1)
    slice_ms = time_ms(lambda: k8.lb_step_tiled_cuda(ds, fs, tau, slat, tile))
    log(f"  K9 against tiled_plain on the slice {slat}: err {slice_err:.3e}; "
        f"K9 {slice_ms:.4f} ms, tiled_plain {tp_ms:.4f} ms there")

    k9_ms = time_ms(lambda: k8.lb_step_tiled_cuda(dist, force, tau, lat, tile))
    k5_ms = time_ms(lambda: k8.lb_step_cuda(dist, force, tau, lat, vvl))
    k9c_ms = time_ms(lambda: k8.lb_step_tiled_cuda(dist, force, tau, lat, tile, with_u=False))
    log(f"  K9 at {lat}: {k9_ms:.4f} ms; K5L {k5_ms:.4f} ms; lb_collide_propagate "
        f"{k9c_ms:.4f} ms; both against lb_step_plain on the whole lattice (the rows' error "
        f"and plain time)")
    rows = {}
    add_row(rows, "lb_step_tiled", err, k9_ms, plain_ms, 176 * V, FLOPS["lb_step"] * V)
    add_row(rows, "lb_collide_propagate_tiled", err_cp, k9c_ms, plain_cp_ms, 164 * V,
            FLOPS["collide"] * V)
    del dist, force, d9, ds, fs, got2, got_u, want2, want_u
    torch.cuda.empty_cache()
    return rows, p


def run_tiled(state, after_steps, cfg, l3_ms):
    """T2: LUDWIG_STEPS steps under the budget from the L1 state, bitwise
    equal to L3's, through K9 alone, ms a step beside L3's; then the fused
    LB half-step under the budget through K9 alone."""
    tcfg = dataclasses.replace(
        cfg, target=dataclasses.replace(cfg.target, smem_bytes=SMEM_BUDGET))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = state
    for _ in range(LUDWIG_STEPS):
        s = step(s, tcfg)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / LUDWIG_STEPS
    counts = path_counts(TILED_PATH)
    untiled = k8.LB_STEP.launches
    log(f"T2: ludwig {cfg.lattice} under a {SMEM_BUDGET} B budget: {step_s * 1e3:.3f} ms/step "
        f"over {LUDWIG_STEPS} steps, {step_s * 1e3 / l3_ms:.3f}x L3's untiled {l3_ms:.3f}; "
        f"launches K9 {counts}, K5L {untiled}")
    exact_err(s.dist.data, after_steps.dist.data, "tiled steps' dist against L3's")
    exact_err(s.q.data, after_steps.q.data, "tiled steps' q against L3's")
    if counts["lb_step_tiled"] != LUDWIG_STEPS or untiled:
        raise AssertionError("the tiled step did not run K9 once a step and K5L never")
    del s

    V = math.prod(cfg.lattice)
    gen = torch.Generator(device=state.dist.data.device).manual_seed(3)
    force = Field.from_canonical(
        "force", 1e-3 * torch.randn((3, V), generator=gen, device=state.dist.data.device),
        cfg.lattice)
    want = collide_propagate(state.dist, force, tau=cfg.tau, config=cfg.target)
    reset_counts()
    got = collide_propagate(state.dist, force, tau=cfg.tau, config=tcfg.target)
    xcounts = path_counts(TILED_EXHIBIT_PATH)
    log(f"  collide_propagate under the budget: bitwise equal to the untiled launch; "
        f"launches {xcounts}, K5L {k8.LB_STEP.launches}")
    exact_err(got.data, want.data, "collide_propagate under the budget against untiled")
    if xcounts["lb_collide_propagate_tiled"] != 1 or k8.LB_STEP.launches:
        raise AssertionError("the budgeted collide_propagate did not run K9 alone")
    return counts, xcounts, step_s


def ludwig_tiled_small(small):
    """T3: 5 steps on the cuda engine under a budget that picks an odd tile
    against 5 untiled steps on the torch engine, both on the card."""
    cfgs = [LudwigConfig(lattice=small, target=TargetConfig("cuda", device="cuda",
                                                            smem_bytes=T3_BUDGET)),
            LudwigConfig(lattice=small, target=TargetConfig("torch", device="cuda"))]
    p = plan.default_plan(cfgs[0].target, nsites=math.prod(small), layouts=[SOA],
                          stencil=True, lattice=small, smem_views=lb_smem_views(cfgs[0]))
    log(f"T3: budget {T3_BUDGET} B -> plan {p.describe()} at {small}")
    if (p.bx, p.by, p.bz) != T3_TILE:
        raise AssertionError(f"expected the tile {T3_TILE} at {small}, got {p}")
    launches = k8.LB_STEP_TILED.launches
    states = [init_state(c, seed=0) for c in cfgs]
    for _ in range(5):
        states = [step(s, c) for s, c in zip(states, cfgs)]
    if k8.LB_STEP_TILED.launches - launches != 5:
        raise AssertionError("T3's steps did not run K9")
    (sc, st) = states
    for name, a, b in (("q", sc.q.data, st.q.data), ("dist", sc.dist.data, st.dist.data)):
        err = (a - b).abs().max().item()
        log(f"T3: ludwig {small}, tile {T3_TILE}, 5 steps: {name} tiled cuda vs torch engine "
            f"max abs diff {err:.3e}")
        if not torch.allclose(a, b, rtol=ENGINE_RTOL, atol=ENGINE_ATOL):
            raise AssertionError(f"tiled cuda and torch engines disagree on {name}")


# -- the tiled lowering's further instances: K9 off SoA and under bf16 (T1, T2),
# -- K5T (T4, T5) and the fused LC chain (K3C) ---------------------------------------

def check_tiled_layouts(state, cfg, vvl, tile):
    """T1 (continued): K9 in AoS and aosoa4, on aosoa4 through the graph
    under view="block", and K9's bf16 policy instance, each on T1's inputs
    bitwise K5L's launch in that layout or policy and the plain LB step's
    (the pinned collision), timed beside K5L.  Returns (rows, {row: K5L's
    ms})."""
    lat, tau = cfg.lattice, cfg.tau
    V = math.prod(lat)
    dev = state.dist.data.device
    gen = torch.Generator(device=dev).manual_seed(4)
    dist = state.dist.data * (1.0 + 0.05 * torch.randn((19, V), generator=gen, device=dev))
    force = 1e-3 * torch.randn((3, V), generator=gen, device=dev)
    rows, k5l = {}, {}
    cases = [(spec, False) for spec in T1_LAYOUTS] + [("soa", True)]
    for spec, bf16 in cases:
        lay = parse_layout(spec)
        L = {"dist": lay, "force": lay, "dist2": lay, "u": lay}
        d, f = lay.pack(dist), lay.pack(force)
        name = "lb_step_tiled_bf16" if bf16 else f"lb_step_tiled@{spec}"
        k5 = k8.lb_step_cuda(d, f, tau, lat, vvl, layouts=L, bf16=bf16)
        k9 = k8.lb_step_tiled_cuda(d, f, tau, lat, tile, layouts=L, bf16=bf16)
        want = k8.lb_step_plain(d, f, tau, lat, layouts=L, bf16=bf16)
        for o, g, w, p in zip(("dist2", "u"), k9, k5, want):
            exact_err(g.float(), w.float(), f"T1 {name} {o} against K5L's")
            exact_err(g.float(), p.float(), f"T1 {name} {o} against lb_step_plain")
        del k5, k9, want
        ms = time_ms(lambda: k8.lb_step_tiled_cuda(d, f, tau, lat, tile, layouts=L, bf16=bf16))
        k5l[name] = time_ms(lambda: k8.lb_step_cuda(d, f, tau, lat, vvl, layouts=L, bf16=bf16))
        plain_ms = time_ms(lambda: k8.lb_step_plain(d, f, tau, lat, layouts=L, bf16=bf16),
                           reps=3, warm=1)
        add_row(rows, name, 0.0, ms, plain_ms, (132 if bf16 else 176) * V, FLOPS["lb_step"] * V)
        log(f"  {name}: bitwise K5L's launch in {spec}{' (bf16)' if bf16 else ''} and the "
            f"plain LB step; K5L {k5l[name]:.4f} ms")
        if spec == "aosoa4":
            # the LB half-step's graph under the tiled plan in the native AoSoA view
            bplan = LoweringPlan("cuda", bx=tile[0], by=tile[1], bz=tile[2], view="block")
            g = ludwig.lb_step_graph(cfg)
            ins = {"dist": Field("dist", 19, lat, lay, d), "force": Field("force", 3, lat, lay, f)}

            def block_launch():
                return g.launch(ins, config=cfg.target, outputs=("dist2", "u"), plan=bplan,
                                out_layouts={"dist2": lay, "u": lay})

            out = block_launch()
            for o in ("dist2", "u"):
                exact_err(out[o].data, k8.lb_step_cuda(d, f, tau, lat, vvl, layouts=L)[
                    0 if o == "dist2" else 1], f"T1 view='block' {o} against K5L's")
            del out
            bname = "lb_step_tiled@aosoa4/block"
            k5l[bname] = k5l[name]
            add_row(rows, bname, 0.0, time_ms(block_launch), plain_ms, 176 * V,
                    FLOPS["lb_step"] * V)
            log(f"  {bname}: plan {bplan.describe()}, bitwise K5L's launch in aosoa4")
        del d, f
    del dist, force
    torch.cuda.empty_cache()
    return rows, k5l


def run_tiled_layouts(state, after_steps, cfg, tile):
    """T2 (continued), each window counted: LUDWIG_STEPS steps under the
    budget from the L1 state repacked into AoS and aosoa4, bitwise L3's
    (K9 in that layout, K5L never); one LB half-step on aosoa4 through the
    graph under the tiled plan in view="block"; T2_BF16_STEPS steps with
    bf16 LB storage under the budget, bitwise as many bf16 steps untiled
    (K9's policy instance, K5L's never).  Returns ({row: launches}, {row:
    ms a step})."""
    counts, step_ms = {}, {}
    btarget = dataclasses.replace(cfg.target, smem_bytes=SMEM_BUDGET)
    for spec in T1_LAYOUTS:
        lay = parse_layout(spec)
        lcfg = dataclasses.replace(cfg, layout=lay, target=btarget)
        s = ludwig.LudwigState(dist=state.dist.as_layout(lay), q=state.q.as_layout(lay))
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LUDWIG_STEPS):
            s = step(s, lcfg)
        torch.cuda.synchronize()
        name = f"lb_step_tiled@{spec}"
        step_ms[name] = (time.perf_counter() - t0) / LUDWIG_STEPS * 1e3
        counts[name] = k8.LB_STEP_TILED.launches
        exact_err(s.dist.canonical(), after_steps.dist.data, f"T2 {spec}: dist against L3's")
        exact_err(s.q.canonical(), after_steps.q.data, f"T2 {spec}: q against L3's")
        if counts[name] != LUDWIG_STEPS or k8.LB_STEP.launches:
            raise AssertionError(f"T2 {spec}: K9 launched {counts[name]} times, K5L "
                                 f"{k8.LB_STEP.launches}")
        log(f"T2: ludwig {cfg.lattice} in {spec} under the budget: {step_ms[name]:.3f} ms/step, "
            f"bitwise L3's; K9 launches {counts[name]}")
        del s
    lay = parse_layout("aosoa4")
    V = math.prod(cfg.lattice)
    gen = torch.Generator(device=state.dist.data.device).manual_seed(3)
    force = Field.from_canonical(
        "force", 1e-3 * torch.randn((3, V), generator=gen, device=state.dist.data.device),
        cfg.lattice, lay)
    ins = {"dist": state.dist.as_layout(lay), "force": force}
    g = ludwig.lb_step_graph(cfg)
    want = g.launch(ins, config=cfg.target, outputs=("dist2", "u"))
    reset_counts()
    got = g.launch(ins, config=cfg.target, outputs=("dist2", "u"),
                   plan=LoweringPlan("cuda", bx=tile[0], by=tile[1], bz=tile[2], view="block"))
    counts["lb_step_tiled@aosoa4/block"] = k8.LB_STEP_TILED.launches
    for o in ("dist2", "u"):
        exact_err(got[o].data, want[o].data, f"T2 view='block' {o} against the untiled launch")
    if counts["lb_step_tiled@aosoa4/block"] != 1 or k8.LB_STEP.launches:
        raise AssertionError("T2: the block-view LB half-step did not run K9 alone")
    del ins, force, want, got
    runs = {}
    for budget in (None, SMEM_BUDGET):
        bcfg = dataclasses.replace(cfg, storage="bfloat16", target=dataclasses.replace(
            cfg.target, smem_bytes=budget))
        s = state
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(T2_BF16_STEPS):
            s = step(s, bcfg)
        torch.cuda.synchronize()
        runs[budget] = (s, (time.perf_counter() - t0) / T2_BF16_STEPS * 1e3,
                        k8.LB_STEP_TILED_BF16.launches, k8.LB_STEP_BF16.launches)
    (s0, ms0, _, u0), (s1, ms1, t1, u1) = runs[None], runs[SMEM_BUDGET]
    exact_err(s1.dist.data, s0.dist.data, "T2 bf16: tiled dist against untiled")
    exact_err(s1.q.data, s0.q.data, "T2 bf16: tiled q against untiled")
    if (t1, u1, u0) != (T2_BF16_STEPS, 0, T2_BF16_STEPS):
        raise AssertionError(f"T2 bf16: K9 bf16 launches {t1}, K5L bf16 {u1} (untiled {u0})")
    counts["lb_step_tiled_bf16"], step_ms["lb_step_tiled_bf16"] = t1, ms1
    log(f"T2: {T2_BF16_STEPS} bf16-storage steps under the budget: {ms1:.3f} ms/step "
        f"(untiled {ms0:.3f}), bitwise the untiled bf16 steps; K9 bf16 launches {t1}")
    del runs, s0, s1
    torch.cuda.empty_cache()
    return counts, step_ms


def normal_t_launch(kernel, p, u, lat, tile=None):
    """t of K5's (tile None) or K5T's t kernel alone on SoA p and u, at
    block 128 (fp32, one slot)."""
    t = torch.empty((24, p.shape[-1]), device=p.device)
    d = SOA.descriptor()
    args = (*lat, d, d, 128) if tile is None else (*lat, 1, *tile, d, d, 128)
    kernel.launch(p.device, p.data_ptr(), u.data_ptr(), t.data_ptr(), KAPPA, *args)
    return t


def check_tiled_normal(cfg, u, b, x_soa, iterations, solve_s, vvl):
    """T4: the MILC solve at ``cfg.lattice`` under the 227 KiB budget, on
    K5T; then K5T on phase 3's inputs against K5 and its plain version,
    timed.  Returns (rows, counts, summary, plan tile)."""
    lat = cfg.lattice
    V = math.prod(lat)
    bcfg = dataclasses.replace(cfg, target=dataclasses.replace(cfg.target,
                                                               smem_bytes=SMEM_BUDGET))
    views = (((24, 2, 4), (72, 2, 4)), ((24, 4),))
    p_ = plan.default_plan(bcfg.target, nsites=V, layouts=[SOA], stencil=True, lattice=lat,
                           smem_views=views)
    tile = (p_.bx, p_.by, p_.bz)
    log(f"T4: budget {SMEM_BUDGET} B -> plan {p_.describe()} at {lat} (the reference's window "
        f"model {plan.estimate_smem_bytes(p_, lattice=lat, in_views=views[0])} B; K5T stages "
        f"none)")
    if not p_.tiled:
        raise AssertionError(f"T4: plan {p_} is not tiled")
    reset_counts()
    res, dt = solve_timed(bcfg, u, b)
    counts = path_counts(NORMAL_TILED_PATH)
    untiled = path_counts(PATH)["wilson_normal"]
    rc = residual_check(bcfg, u, b, res.x)
    rel = (torch.linalg.norm(res.x.data - x_soa) / torch.linalg.norm(x_soa)).item()
    log(f"T4: solve {lat} under the budget: {res.iterations} iterations (phase 4: "
        f"{iterations}), {dt:.3f} s ({dt / max(res.iterations, 1) * 1e3:.3f} ms/iter; phase 4: "
        f"{solve_s:.3f} s), |Mx-b|/|b| = {rc:.3e}, x rel-L2 {rel:.3e} from phase 4's "
        f"(bitwise: {bool(torch.equal(res.x.data, x_soa))}); K5T launches {counts}, K5 {untiled}")
    if abs(res.iterations - iterations) > 1 or not rel <= 1e-5 or not rc < 1e-3:
        raise AssertionError("T4: the budgeted solve is off phase 4's")
    if counts["wilson_normal_tiled"] != 2 * res.iterations or untiled:
        raise AssertionError("T4: the budgeted solve did not run K5T twice an iteration, K5 never")
    summary = dict(plan=p_.describe(), iterations=res.iterations, s=dt, residual_check=rc,
                   x_rel=rel, x_bitwise=bool(torch.equal(res.x.data, x_soa)))
    del res
    inp = milc_inputs(u, b, vvl)
    p, uu = inp["p"], inp["u"]
    t5 = normal_t_launch(wk.WILSON_NORMAL_T, p, uu, lat)
    ap5, pap5 = wk.wilson_normal_cuda(p, uu, KAPPA, lat, vvl)
    err = 0.0
    for tl in (tile, K5T_WALK_TILE):
        what = f"T4: K5T at tile {tl}"
        exact_err(normal_t_launch(wk.WILSON_NORMAL_T_TILED, p, uu, lat, tl), t5,
                  f"{what}: t against K5's")
        ap, pap = wk.wilson_normal_tiled_cuda(p, uu, KAPPA, lat, tl)
        exact_err(ap, ap5, f"{what}: ap against K5's")
        want_ap, want = wk.wilson_normal_tiled_plain(p, uu, KAPPA, lat, tl)
        err = max(err, field_err(ap, want_ap, f"{what}: ap against its plain version"),
                  sum_err(pap, want, p * want_ap, f"{what}: pap against its plain version"))
        if not torch.allclose(pap, want, rtol=1e-6, atol=0.0):
            raise AssertionError(f"{what}: pap beyond rtol 1e-6 of its plain version: "
                                 f"{(pap - want).abs().max().item()}")
        exact_err(wk.wilson_normal_tiled_cuda(p, uu, KAPPA, lat, tl)[1], pap,
                  f"{what}: pap on a rerun")
        if tl == tile:
            pap_bits = bool(torch.equal(pap, pap5))
    log(f"  K5T at tile {K5T_WALK_TILE}: t and ap bitwise K5's, pap within rtol 1e-6 of its "
        f"plain version and bitwise on a rerun")
    ms = time_ms(lambda: wk.wilson_normal_tiled_cuda(p, uu, KAPPA, lat, tile))
    k5_ms = time_ms(lambda: wk.wilson_normal_cuda(p, uu, KAPPA, lat, vvl))
    plain_ms = time_ms(lambda: wk.wilson_normal_tiled_plain(p, uu, KAPPA, lat, tile), reps=3,
                       warm=1)
    rows = {}
    add_row(rows, "wilson_normal_tiled", err, ms, plain_ms, 480 * V, NORMAL_FLOPS * V)
    floor = 1056 * V / HBM_BYTES_PER_S * 1e3
    log(f"  K5T at {lat}, tile {tile}: t and ap bitwise K5's, pap within rtol 1e-6 of its "
        f"plain version and bitwise on a rerun (bitwise K5's: {pap_bits}); {ms:.4f} ms against "
        f"K5 {k5_ms:.4f} ms, the bound {rows['wilson_normal_tiled']['bound_ms']:.4f} ms and "
        f"the two-launch floor {floor:.4f} ms")
    summary.update(k5t_ms=ms, k5_ms=k5_ms, floor_ms=floor, pap_bitwise_k5=pap_bits)
    del inp, p, uu, t5, ap, pap, ap5, want_ap, want
    torch.cuda.empty_cache()
    return rows, counts, summary, tile


def check_tiled_normal_serving(cfg, u, b, tile, vvl, seed, refined):
    """T5: under the 227 KiB budget, solve_batched on S2's four sources (K5T
    batched, each slot bitwise the budgeted solve of its source) and the
    refined solve (K5T's policy instance), each counted, the refined solve
    held against ``refined`` (P2's untiled refined solve: iterations, x on
    the host); K5T batched (4 slots) and its policy instance timed beside
    K5B and K5's policy instance on phase 3's inputs, and checked again at
    K5T_WALK_TILE.  Returns (rows, {row: launches}, summary)."""
    lat = cfg.lattice
    V = math.prod(lat)
    bcfg = dataclasses.replace(cfg, target=dataclasses.replace(cfg.target,
                                                               smem_bytes=SMEM_BUDGET))
    bs = serve_sources(cfg, u, seed)
    reset_counts()
    res, dt = solve_timed_batched(bcfg, u, bs)
    counts = {"wilson_normal_tiled_batched": path_counts(NORMAL_TILED_PATH)["wilson_normal_tiled"]}
    its = res.iterations.tolist()
    if counts["wilson_normal_tiled_batched"] != 2 * max(its) or wk.WILSON_NORMAL_AP_B.launches:
        raise AssertionError(f"T5: solve_batched launched K5T {counts}, K5B "
                             f"{wk.WILSON_NORMAL_AP_B.launches}")
    for i in range(3):
        one = solve(bcfg, u, bs[i])
        same_outcome(res.x.element(i), its[i], res.residual[i], one, f"T5 slot {i}")
    log(f"T5: solve_batched {lat}, {SLOTS} slots under the budget: iterations {its}, {dt:.3f} s; "
        f"each slot bitwise the budgeted solve of its source; K5T launches {counts}")
    summary = dict(batched_iterations=its, batched_s=dt)
    del res, bs
    mcfg = dataclasses.replace(bcfg, storage="bfloat16")
    reset_counts()
    res, rdt = solve_timed(mcfg, u, b)
    counts["wilson_normal_tiled_policy"] = path_counts(
        NORMAL_TILED_POLICY_PATH)["wilson_normal_tiled_policy"]
    rc = residual_check(cfg, u, b, res.x)
    its_p2, x_p2 = refined
    x_p2 = x_p2.to(res.x.data.device)
    rel = (torch.linalg.norm(res.x.data - x_p2) / torch.linalg.norm(x_p2)).item()
    bits = bool(torch.equal(res.x.data, x_p2))
    log(f"T5: refined solve {lat} (bf16 storage) under the budget: {res.iterations} inner "
        f"iterations (P2 untiled: {its_p2}), {rdt:.3f} s, |Mx-b|/|b| = {rc:.3e}, x rel-L2 "
        f"{rel:.3e} from P2's (bitwise: {bits}); K5T policy launches "
        f"{counts['wilson_normal_tiled_policy']}, K5 policy {wk.WILSON_NORMAL_AP_MIXED.launches}")
    if not rc < 1e-3 or not counts["wilson_normal_tiled_policy"] or \
            wk.WILSON_NORMAL_AP_MIXED.launches:
        raise AssertionError("T5: the budgeted refined solve is off or missed K5T's policy "
                             "instance")
    if abs(res.iterations - its_p2) > 1 or not rel <= 1e-5:
        raise AssertionError("T5: the budgeted refined solve is off P2's untiled one")
    summary.update(refined_iterations=res.iterations, refined_s=rdt, refined_residual=rc,
                   refined_x_rel_p2=rel, refined_x_bitwise_p2=bits)
    del res, x_p2
    inp = batch_inputs(lat, SOA)
    rows = {}
    pb, uu = inp["p"], u.data
    ap, pap = wk.wilson_normal_tiled_cuda(pb, uu, KAPPA, lat, tile, batched=True)
    for s_ in range(pb.shape[0]):
        one = wk.wilson_normal_tiled_cuda(pb[s_], uu, KAPPA, lat, tile)
        exact_err(ap[s_], one[0], f"T5: K5T batched ap slot {s_} against its single launch")
        exact_err(pap[s_], one[1], f"T5: K5T batched pap slot {s_} against its single launch")
    want_ap, want = wk.wilson_normal_tiled_plain(pb, uu, KAPPA, lat, tile, batched=True)
    err = max(field_err(ap, want_ap, "T5: K5T batched ap against its plain version"),
              sum_err(pap, want, (pb * want_ap).reshape(pb.shape[0], 24, -1),
                      "T5: K5T batched pap against its plain version"))
    ms = time_ms(lambda: wk.wilson_normal_tiled_cuda(pb, uu, KAPPA, lat, tile, batched=True))
    k5b_ms = time_ms(lambda: wk.wilson_normal_cuda(pb, uu, KAPPA, lat, vvl, batched=True))
    plain_ms = time_ms(lambda: wk.wilson_normal_tiled_plain(pb, uu, KAPPA, lat, tile,
                                                            batched=True), reps=2, warm=1)
    nb = pb.shape[0]
    add_row(rows, "wilson_normal_tiled_batched", err, ms, plain_ms, (192 * nb + 288) * V,
            NORMAL_FLOPS * nb * V)
    ap, pap = wk.wilson_normal_tiled_cuda(pb, uu, KAPPA, lat, K5T_WALK_TILE, batched=True)
    for s_ in range(nb):
        what = f"T5: K5T batched at tile {K5T_WALK_TILE}, slot {s_}"
        one = wk.wilson_normal_tiled_cuda(pb[s_], uu, KAPPA, lat, K5T_WALK_TILE)
        exact_err(ap[s_], one[0], f"{what}: ap against its single launch")
        exact_err(pap[s_], one[1], f"{what}: pap against its single launch")
        exact_err(one[0], wk.wilson_normal_cuda(pb[s_], uu, KAPPA, lat, vvl)[0],
                  f"{what}: ap against K5's")
    del ap, pap, one, want_ap, want
    pol = CudaPolicy(True, True)
    p1 = pb[0].contiguous()
    u16 = wk.bf16_pack_cuda(uu)
    ap_m, pap_m = wk.wilson_normal_tiled_cuda(p1, u16, KAPPA, lat, tile, policy=pol)
    ap5_m, _ = wk.wilson_normal_cuda(p1, u16, KAPPA, lat, vvl, policy=pol)
    exact_err(ap_m.float(), ap5_m.float(), "T5: K5T policy ap against K5's policy instance")
    want_ap, want = wk.wilson_normal_tiled_plain(p1, uu, KAPPA, lat, tile, policy=pol)
    err_m = max(bf16_err(ap_m, want_ap, "T5: K5T policy ap against its plain version"),
                sum_err(pap_m, want, wk.bf16_round(p1) * want_ap.float(),
                        "T5: K5T policy pap against plain"))
    # the compensated pap's plain version takes no tile: the same want holds
    apx_m, papx_m = wk.wilson_normal_tiled_cuda(p1, u16, KAPPA, lat, K5T_WALK_TILE, policy=pol)
    exact_err(apx_m.float(), ap5_m.float(),
              f"T5: K5T policy at tile {K5T_WALK_TILE}: ap against K5's policy instance")
    err_m = max(err_m, sum_err(papx_m, want, wk.bf16_round(p1) * want_ap.float(),
                               f"T5: K5T policy at tile {K5T_WALK_TILE}: pap against plain"))
    del apx_m, papx_m
    ms_m = time_ms(lambda: wk.wilson_normal_tiled_cuda(p1, u16, KAPPA, lat, tile, policy=pol))
    k5m_ms = time_ms(lambda: wk.wilson_normal_cuda(p1, u16, KAPPA, lat, vvl, policy=pol))
    plain_m = time_ms(lambda: wk.wilson_normal_tiled_plain(p1, uu, KAPPA, lat, tile, policy=pol),
                      reps=3, warm=1)
    add_row(rows, "wilson_normal_tiled_policy", err_m, ms_m, plain_m, 288 * V, NORMAL_FLOPS * V)
    log(f"  K5T batched ({nb} slots) {ms:.4f} ms against K5B {k5b_ms:.4f} ms; K5T policy "
        f"{ms_m:.4f} ms against K5's policy instance {k5m_ms:.4f} ms")
    summary.update(k5t_batched_ms=ms, k5b_ms=k5b_ms, k5t_policy_ms=ms_m, k5_policy_ms=k5m_ms)
    del inp, pb, uu, u16, p1, ap_m, ap5_m, want_ap, want
    torch.cuda.empty_cache()
    return rows, counts, summary


def solve_timed_batched(cfg, u, bs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_batched(cfg, u, bs)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def check_lc_chain(state, cfg, vvl):
    """The K3C row (after L4): the fused LC chain at the Ludwig lattice in
    SoA and AoS against its plain version (within LC_CHAIN_RTOL x
    max|plain|), against the K3L pair's composition (chem_stress's h fed to
    lc_update: bitwise or not, logged), timed beside its bound and the K3L
    pair; the lc_chain graph's launch in each layout counted.  Returns
    (rows, counts, summary)."""
    lat = cfg.lattice
    V = math.prod(lat)
    dev = state.q.data.device
    gen = torch.Generator(device=dev).manual_seed(6)
    q = state.q.data
    _, lapq_nd = ludwig.stage_gradients(state.q.canonical_nd())
    arrs = {"q": q, "lapq": lapq_nd.reshape(5, V),
            "w": 1e-2 * torch.randn((9, V), generator=gen, device=dev),
            "adv": 1e-2 * torch.randn((5, V), generator=gen, device=dev)}
    kw = dict(a0=cfg.a0, gamma=cfg.gamma, kappa=cfg.kappa, gamma_rot=cfg.gamma_rot, xi=cfg.xi,
              dt=cfg.dt)
    names = ("q", "lapq", "w", "adv")
    rows, counts, summary = {}, {}, {}
    g = ludwig.lc_chain_graph(cfg)
    for spec in ("soa", "aos"):
        lay = parse_layout(spec)
        L = {**{n: lay for n in names}, "q_new": lay}
        phys = [lay.pack(arrs[n]) for n in names]
        got = lk.lc_chain_cuda(*phys, vvl=vvl, layouts=L, **kw)
        want = lk.lc_chain_plain(*phys, layouts=L, **kw)
        err = (got - want).abs().max().item()
        if not err <= LC_CHAIN_RTOL * want.abs().max().item():
            raise AssertionError(f"K3C in {spec}: max abs err {err} beyond {LC_CHAIN_RTOL} x "
                                 f"max|plain|")
        dq = lay.pack(torch.zeros((15, V), device=dev))
        lcs = {"q": lay, "lapq": lay, "dq": lay, "h": lay, "sigma": lay}
        llu = {"q": lay, "h": lay, "w": lay, "adv": lay, "q_new": lay}

        def k3l_pair():
            h, _ = lk.chem_stress_cuda(phys[0], phys[1], dq, a0=cfg.a0, gamma=cfg.gamma,
                                       kappa_m=cfg.kappa, kappa_s=cfg.kappa, xi=cfg.xi,
                                       vvl=vvl, layouts=lcs)
            return lk.lc_update_cuda(phys[0], h, phys[2], phys[3], gamma_rot=cfg.gamma_rot,
                                     xi=cfg.xi, dt=cfg.dt, vvl=vvl, layouts=llu)

        pair = k3l_pair()
        bits = bool(torch.equal(got, pair))
        pair_err = (got - pair).abs().max().item()
        ms = time_ms(lambda: lk.lc_chain_cuda(*phys, vvl=vvl, layouts=L, **kw))
        pair_ms = time_ms(k3l_pair)
        plain_ms = time_ms(lambda: lk.lc_chain_plain(*phys, layouts=L, **kw), reps=3, warm=1)
        name = "ludwig_lc_chain" if spec == "soa" else "ludwig_lc_chain@aos"
        add_row(rows, name, err, ms, plain_ms, 116 * V, FLOPS["lc_chain"] * V)
        summary[spec] = dict(ms=ms, k3l_pair_ms=pair_ms, bitwise_k3l_pair=bits,
                             k3l_pair_max_abs_diff=pair_err)
        ins = {n: Field(n, a.shape[0], lat, lay, p_) for (n, a), p_ in zip(arrs.items(), phys)}
        reset_counts()
        out = g.launch(ins, config=cfg.target, outputs=("q_new",), out_layouts={"q_new": lay})
        counts[name] = lk.LC_CHAIN.launches
        exact_err(out["q_new"].data, got, f"K3C in {spec}: the graph's launch against the "
                                         f"wrapper's")
        if counts[name] != 1:
            raise AssertionError(f"K3C in {spec}: the lc_chain graph launched it "
                                 f"{counts[name]} times")
        log(f"  K3C in {spec}: bitwise the K3L pair's composition: {bits} (max abs diff "
            f"{pair_err:.3e}); the K3L pair {pair_ms:.4f} ms")
        del got, want, dq, pair, out, phys, ins
    torch.cuda.empty_cache()
    return rows, counts, summary


def wkv_work(BH, T, C, dk, dv):
    """(bytes, operations) of one K10 call: r, k, v, w read and o written
    once, u, s0 and sT; per chunk the causal pairs only, each exp and log
    counted as one operation (the kernel's note has the breakdown)."""
    nbytes = 4 * (BH * T * (3 * dk + 2 * dv) + BH * dk + 2 * BH * dk * dv)
    pairs = C * (C - 1) // 2
    per_chunk = (11 * C * dk + 6 * pairs * dk + 2 * pairs * dv + 4 * C * dk * dv
                 + 3 * C * dv + dk + 2 * dk * dv)
    return nbytes, per_chunk * BH * (T // C)


def wkv_problem(gen, BH, T, dk, dv):
    """tests/test_kernels_rwkv.py's inputs in K10's (BH, T, d) layout:
    strong decay w = exp(-exp(1 + N(0, 1))) and a random u."""
    def n(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")
    w = torch.exp(-torch.exp(1.0 + n(BH, T, dk)))
    return n(BH, T, dk), n(BH, T, dk, scale=0.3), n(BH, T, dv), w, n(BH, dk, scale=0.5), \
        n(BH, dk, dv, scale=0.1)


def wkv_err(got, want, name, rtol=WKV_RTOL, atol_rel=WKV_ATOL_REL):
    err = (got - want).abs()
    lim = atol_rel * want.abs().max() + rtol * want.abs()
    if not bool((err <= lim).all()):
        raise AssertionError(f"{name}: max abs err {err.max().item()} beyond rtol {rtol}, "
                             f"atol {atol_rel} x max|want| = {lim.min().item()}")
    return err.max().item()


def wkv_floor(BH, T, C, dk, dv, itemsize=2):
    """K10's own floor in ms, and what sets it: r, k, v, w read and o written
    once at ``itemsize`` bytes with u, s0 and sT in fp32; its products (q S,
    A left of the diagonal, A v, kd^T v) three times at the TF32 tensor-core
    rate; its exponentials and logarithms at the MUFU rate (csrc/rwkv6.cu's
    note counts them)."""
    sub, nc = 16, BH * T // C
    ns = -(-C // sub)
    nbytes = itemsize * BH * T * (3 * dk + 2 * dv) + 4 * (BH * dk + 2 * BH * dk * dv)
    prods = 4 * C * dk * dv + sum(2 * sub * sub * (i * dk + (i + 1) * dv) for i in range(ns))
    exps = (ns * sub * (sub - 1) // 2 * dk + 4 * C * dk + dk
            + sum(sub * dk + sub * i * dk for i in range(1, ns)))
    parts = {"bytes": nbytes / HBM_BYTES_PER_S, "tensor cores": 3 * prods * nc / TF32_TC_FLOP_PER_S,
             "exponentials": exps * nc / MUFU_PER_S}
    by = max(parts, key=parts.get)
    return parts[by] * 1e3, by


def wkv_split_ms(r, k, v, w, u, s0, C):
    """The state pass and the output pass of one fp32 (BH, T, d) call, each
    timed alone (launched through the library, outside the counts)."""
    BH, T, dk = r.shape
    dv = v.shape[-1]
    xs = [x[:, None] for x in (r, k, v, w)]
    states = torch.empty((BH, T // C, dk, dv), device="cuda")
    sT = torch.empty((BH, dk, dv), device="cuda")
    o = torch.empty((BH, T, dv), device="cuda")
    lib = _cuda.library()
    st, vst = xs[0].stride()[:3], xs[2].stride()[:3]

    def state():
        rc = lib.rt_rwkv6_state(xs[1].data_ptr(), xs[2].data_ptr(), xs[3].data_ptr(),
                                s0.data_ptr(), states.data_ptr(), sT.data_ptr(), BH, 1, T, C,
                                dk, dv, *st, *vst, 0, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc

    def output():
        rc = lib.rt_rwkv6_output(xs[0].data_ptr(), xs[1].data_ptr(), xs[2].data_ptr(),
                                 xs[3].data_ptr(), u.data_ptr(), states.data_ptr(), o.data_ptr(),
                                 BH, 1, T, C, dk, dv, *st, *vst, dk, 0, T * dv, 0, dv, 0, 0,
                                 torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc

    return time_ms(state), time_ms(output)


def wkv_heads_fp32_out(views, u, s0, chunk):
    """K10 on bf16 (B, H, T, d) views, as the model's prefill runs it, but
    with o stored in fp32: the bf16 instance's arithmetic without o's
    rounding to bf16."""
    B, H, T, _ = views[0].shape
    o = k10._heads_out(B, H, T, views[2].shape[-1], torch.float32, views[0].device)
    k10._launch(*k10._operands(*views), u, 0, u.stride(0), s0, o, chunk)
    return o


def check_wkv_kernel(ptxas):
    """R1: K10 against its plain version at the prefill's shapes, at a
    batch-1 long prompt and at T 100 with small heads, on fp32 (BH, T, d)
    tensors and on the model's bf16 (B, H, T, d) views (o in bf16 within
    one bf16 ulp, and stored in fp32 within the fp32 tolerance), and
    against the scan oracle; timed, the two passes also alone.  Returns
    the rows and, by row, the design's floor (fp32, bf16) in ms."""
    for ln in ptxas:
        log(f"  ptxas: {ln}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    H, dk = 64, 64
    rows, floors = {}, {}
    for B, T, d, C in ((PREFILL_B, PREFILL_T, dk, 64), (*WKV_LONG, dk, 64),
                       (PREFILL_B, 100, 16, 50)):
        BH = B * H
        r, k, v, w, u, s0 = wkv_problem(gen, BH, T, d, d)
        o, sT = k10.rwkv6_cuda(r, k, v, w, u, s0, chunk=C)
        o_p, s_p = k10.rwkv6_plain(r, k, v, w, u, s0, chunk=C)
        shape = (B, H, T, d, d)
        err = max(wkv_err(o, o_p, f"K10 o at {shape}, chunk {C}"),
                  wkv_err(sT, s_p, f"K10 state at {shape}, chunk {C}"))
        log(f"  K10 at (B, H, T, dk, dv) = {shape}, chunk {C}: max abs err {err:.3e} "
            f"(max|o| {o_p.abs().max().item():.3e}, max|S| {s_p.abs().max().item():.3e})")
        # the model's operands: bf16 (B, H, T, d) views of (B, T, H, d)
        views = [x.reshape(B, H, T, -1).transpose(1, 2).to(torch.bfloat16).contiguous()
                 .transpose(1, 2) for x in (r, k, v, w)]
        ub, s0b = u[:H], s0.reshape(B, H, d, d)
        ob, sb = k10.rwkv6_heads_cuda(*views, ub, s0b, chunk=C)
        ob_p, sb_p = wkv_ref.rwkv6_chunked(*views, ub, s0b, chunk=C)
        err_b = max(wkv_err(ob.float(), ob_p, f"K10 bf16 o at {shape}", rtol=2.0 ** -7),
                    wkv_err(sb, sb_p, f"K10 bf16 state at {shape}"))
        err_b32 = wkv_err(wkv_heads_fp32_out(views, ub, s0b, C), ob_p,
                          f"K10 on bf16 views, o stored in fp32, at {shape}")
        log(f"  K10 on bf16 (B, H, T, d) views at {shape}: o within one bf16 ulp, max abs err "
            f"{err_b:.3e}; o stored in fp32 within the fp32 tolerance, max abs err "
            f"{err_b32:.3e}; o {tuple(ob.stride())} strides, ready for the model's heads merge")
        if T >= PREFILL_T:
            ms = time_ms(lambda: k10.rwkv6_cuda(r, k, v, w, u, s0, chunk=C))
            bf_ms = time_ms(lambda: k10.rwkv6_heads_cuda(*views, ub, s0b, chunk=C))
            st_ms, out_ms = wkv_split_ms(r, k, v, w, u, s0, C)
            plain_ms = time_ms(lambda: k10.rwkv6_plain(r, k, v, w, u, s0, chunk=C), reps=3,
                               warm=1)
            fl32, fl32_by = wkv_floor(BH, T, C, d, d, 4)
            fl16, fl16_by = wkv_floor(BH, T, C, d, d, 2)
            log(f"  K10 at {shape}: fp32 {ms:.4f} ms (state pass {st_ms:.4f}, output pass "
                f"{out_ms:.4f}), bf16 views {bf_ms:.4f} ms, {ms / (B * T) * 1e6:.4f} ns a "
                f"token; the design's floor {fl32:.4f} ms fp32 ({fl32_by}), {fl16:.4f} ms "
                f"bf16 ({fl16_by})")
            name = "rwkv6_wkv" if T == PREFILL_T else "rwkv6_wkv_long"
            add_row(rows, name, err, ms, plain_ms, *wkv_work(BH, T, C, d, d))
            rows[name].update(state_ms=st_ms, output_ms=out_ms, bf16_ms=bf_ms)
            floors[name] = [fl32, fl16]
        del r, k, v, w, u, s0, o, sT, o_p, s_p, views, ob, sb, ob_p, sb_p
    # the scan oracle on a short sequence: two chunks of 64
    B, H, T = 1, 8, 128
    r, k, v, w, u, s0 = wkv_problem(gen, B * H, T, dk, dk)
    o, sT = k10.rwkv6_cuda(r, k, v, w, u, s0, chunk=64)
    o_s, s_s = wkv_ref.rwkv6_scan_ref(r[None], k[None], v[None], w[None], u, s0[None])
    err = max(wkv_err(o, o_s[0], "K10 o against the scan oracle", WKV_SCAN_TOL, WKV_SCAN_TOL),
              wkv_err(sT, s_s[0], "K10 state against the scan oracle", WKV_SCAN_TOL,
                      WKV_SCAN_TOL))
    log(f"  K10 against rwkv6_scan_ref at {(B, H, T, dk, dk)}: max abs err {err:.3e}")
    torch.cuda.empty_cache()
    return rows, floors


def param_stats(params):
    """(count, bytes) of a parameter tree of dictionaries and lists."""
    if isinstance(params, torch.Tensor):
        return params.numel(), params.numel() * params.element_size()
    vals = params.values() if isinstance(params, dict) else params
    stats = [param_stats(v) for v in vals]
    return sum(n for n, _ in stats), sum(b for _, b in stats)


def device_profile(fn, what, kernels=(("rwkv6_wkv", "rwkv6_"),)):
    """fn() under torch.profiler: the device time of its kernels in groups
    (matmuls, the hand kernels named by (group, substring of the kernel's
    name) in ``kernels``, the rest), against the host clock."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    groups = dict.fromkeys(["matmul", *(g for g, _ in kernels), "other"], 0.0)
    for e in events:
        name = e.key.lower()
        g = next((g for g, sub in kernels if sub in name), None) or (
            "matmul" if any(m in name for m in ("gemm", "nvjet", "cutlass", "sm90_xmma")) else
            "other")
        groups[g] += e.self_device_time_total / 1e3
    busy = sum(groups.values())
    log(f"{what} profile: host clock {wall:.3f} ms, kernels {busy:.3f} ms (idle share "
        f"{1 - busy / wall:.3f}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in groups.items()))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms  {e.count:5d}x  {e.key[:90]}")
    return wall, busy, groups


def logit_diff(got, want):
    """(rel-L2 distance, argmax agreement) of two logit tensors."""
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    return rel, (got.argmax(-1) == want.argmax(-1)).float().mean().item()


def check_prefill_against_plain(cfg, params, batch, logits, what):
    """K10's prefill logits against the plain-WKV prefill's, within
    PREFILL_SPREAD x the distance between two plain prefills with chunks of
    64 and 32; returns the rel-L2 distance."""
    plain = build_prefill(cfg, wkv_engine="torch")(params, batch)
    rel, agree = logit_diff(logits, plain)
    tuning.set_tuning(rwkv_chunk=32)
    try:
        plain32 = build_prefill(cfg, wkv_engine="torch")(params, batch)
    finally:
        tuning.reset()
    spread, spread_agree = logit_diff(plain32, plain)
    del plain, plain32
    log(f"R2: {what}: logits against the plain-WKV prefill rel-L2 {rel:.3e}, argmax agreement "
        f"{agree:.4f}; two plain prefills (chunk 32 against 64) rel-L2 {spread:.3e}, argmax "
        f"agreement {spread_agree:.4f}")
    if not rel <= PREFILL_SPREAD * spread:
        raise AssertionError(f"{what}: prefill logits rel-L2 {rel} > {PREFILL_SPREAD} x the "
                             f"plain prefills' spread {spread}")
    return rel


def cast_params(params, dtype):
    """A copy of a parameter tree with its bf16 leaves cast to ``dtype``."""
    if isinstance(params, torch.Tensor):
        return params.to(dtype) if params.dtype == torch.bfloat16 else params
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    return [cast_params(v, dtype) for v in params]


def rwkv_prefill():
    """R2: rwkv6-7b at full width prefills PREFILL_B x PREFILL_T tokens on
    the card, counted; against the plain-WKV prefill; timed."""
    cfg = get_arch("rwkv6-7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n, nbytes = param_stats(params)
    log(f"R2: {cfg.name} initialised on the card in {time.perf_counter() - t0:.1f} s: {n} "
        f"parameters, {nbytes} B")
    if n != RWKV_PARAMS:
        raise AssertionError(f"{cfg.name} has {n} parameters, expected {RWKV_PARAMS}")
    gen = torch.Generator(device="cuda").manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_T), generator=gen,
                                     device="cuda")}
    prefill = build_prefill(cfg)
    reset_counts()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    counts = path_counts(RWKV_PATH)
    log(f"R2: prefill {PREFILL_B} x {PREFILL_T} -> logits {tuple(logits.shape)} "
        f"{logits.dtype}; launches on the prefill's path: {counts}")
    if (k10.WKV_STATE.launches, k10.WKV.launches) != (cfg.n_layers, cfg.n_layers):
        raise AssertionError(f"K10's passes launched {k10.WKV_STATE.launches} and "
                             f"{k10.WKV.launches} times, not once each a layer")
    if not torch.isfinite(logits).all():
        raise AssertionError("prefill logits have non-finite values")
    check_prefill_against_plain(cfg, params, batch, logits, "bf16")
    del logits
    p32 = cast_params(params, torch.float32)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    rel32 = check_prefill_against_plain(cfg32, p32, batch, build_prefill(cfg32)(p32, batch),
                                        "fp32 copy")
    del p32
    torch.cuda.empty_cache()
    if not rel32 < PREFILL_REL_L2_FP32:
        raise AssertionError(f"fp32 prefill logits rel-L2 {rel32} >= {PREFILL_REL_L2_FP32}")
    ms = time_ms(lambda: prefill(params, batch), reps=3, warm=1)
    log(f"R2: prefill {ms:.3f} ms, {PREFILL_B * PREFILL_T / ms * 1e3:.1f} tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    device_profile(lambda: prefill(params, batch), "R2: one prefill")
    return cfg, params, nbytes, counts, ms


def rwkv_serve(cfg, params, nbytes):
    """R3: generate SERVE_NEW greedy tokens for SERVE_B requests after a
    prompt of SERVE_PROMPT tokens fed token by token."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompt = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_PROMPT), generator=gen, device="cuda")
    generate(params, cfg, prompt[:, :2], steps=2, s_max=SERVE_PROMPT + SERVE_NEW)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(params, cfg, prompt, steps=SERVE_NEW, s_max=SERVE_PROMPT + SERVE_NEW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = SERVE_PROMPT + SERVE_NEW
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"R3: generate {SERVE_B} requests, prompt {SERVE_PROMPT}, {SERVE_NEW} new tokens: "
        f"{dt:.3f} s, {steps} decode steps, {dt / steps * 1e3:.3f} ms a step (weight-read "
        f"bound {bound_ms:.3f} ms), {SERVE_B * SERVE_NEW / dt:.1f} new tokens/s")
    log(f"R3: first request's new tokens {out[0, SERVE_PROMPT:].tolist()}")
    if tuple(out.shape) != (SERVE_B, SERVE_PROMPT + SERVE_NEW):
        raise AssertionError(f"generate returned shape {tuple(out.shape)}")
    if not torch.equal(out[:, :SERVE_PROMPT], prompt):
        raise AssertionError("generate did not return the prompt first")
    if not (0 <= int(out.min()) and int(out.max()) < cfg.vocab):
        raise AssertionError("generated tokens outside the vocab")
    step = build_serve_step(cfg)
    cache = init_cache(cfg, SERVE_B, steps, device="cuda")
    with torch.inference_mode():
        device_profile(lambda: step(params, cache, out[:, 0]), "R3: one decode step")
    return dt / steps * 1e3


def flash_err(got, want, name):
    """K11/K12 against its plain version: fp32 within FLASH_RTOL and
    FLASH_ATOL_REL x max|plain|; bf16 within one bf16 ulp of the larger of
    the two outputs (2^-8 to 2^-7 of it: two fp32 results that round to
    neighbouring bf16 values) plus that atol."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    atol = FLASH_ATOL_REL * w.abs().max()
    if got.dtype == torch.float32:
        lim = atol + FLASH_RTOL * w.abs()
    else:
        ulp_exp = torch.frexp(torch.maximum(g.abs(), w.abs())).exponent - 8
        lim = atol + torch.ldexp(torch.ones_like(w), ulp_exp)
    if not bool((err <= lim).all()):
        raise AssertionError(f"{name}: max abs err {err.max().item()} beyond its limit "
                             f"(dtype {got.dtype}, max|plain| {w.abs().max().item()})")
    return err.max().item()


def seen_pairs(S, causal, window):
    """(query, key) pairs the mask lets through, a head."""
    if not causal and window <= 0:
        return S * S
    n = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = i + 1 if causal else S
        n += hi - lo
    return n


def flash_work(BKV, rep, S, dh, causal, window, itemsize):
    """(bytes, fp32 operations, bf16 tensor-core operations) of the
    attention function, K11's or K12's: q, k, v read and o written once; a
    seen pair costs 2 dh for QK^T, once (K11's second sweep is its own
    choice), 2 dh for p v and one exp.  With bf16 inputs QK^T's products are
    exact in fp32, so its fp32-accumulated result is the tensor cores'; p v
    needs p to 16 bits to stay within one bf16 ulp of o (a bf16 p misses
    that limit on ~10% of the elements; tests/test_torch_flash.py), so it
    counts as two bf16 passes, p = hi + lo; the exps stay on the CUDA
    cores.  fp32 inputs: everything on the CUDA cores."""
    nbytes = itemsize * S * dh * (2 * BKV * rep + 2 * BKV)
    pairs = BKV * rep * seen_pairs(S, causal, window)
    qk = 2 * dh * pairs
    if itemsize == 2:
        return nbytes, pairs, 3 * qk
    return nbytes, pairs * (2 * dh + 1) + qk, 0


def flash_toolchain():
    """Run beside phase 2's build: csrc/flash.cu, rwkv6.cu and lb_tiled.cu
    under ``-Xptxas -v`` (each kernel's registers and spills), and, where
    PARENT_SRC holds a tree, the parent's flash.cu, its K1 and K2
    (site_local.cu and reduce.cu, with the parent's headers), its K3, K4 and
    K5 (fused_flat.cu, dslash.cu, wilson_normal.cu and wilson_normal_mixed.cu)
    and its K9 and K10 (lb_tiled.cu, rwkv6.cu) as libraries of their own.
    Returns ({"flash": ptxas lines of the bf16 kernels, "k10": of K10's and
    K9's kernels, "k4_k5l": of K4's, K7's, K8's and K5L's, "k5t_k3c": of K5's
    and K5T's (SoA, one slot, fp32) and K3C's}, {"flash", "k1_k2", "k3_k5",
    "k9_k10", "k5l" (lb.cu): the parent library's path} for those built)."""
    nvcc = _cuda._nvcc()
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmds = [[nvcc, *_cuda.COMPILE_FLAGS, "-Xptxas", "-v", "-cubin", "-o",
             str(_cuda.BUILD_DIR / f"{src}_ptxas.cubin"), str(_cuda.CSRC / f"{src}.cu")]
            for src in ("flash", "rwkv6", "lb_tiled", "dslash", "lb", "wilson_normal",
                        "ludwig_flat")]
    csrc = os.path.join(PARENT_SRC, "repro_torch", "csrc")
    libs = {}
    for tag, srcs in (("flash", ("flash.cu",)), ("k1_k2", ("site_local.cu", "reduce.cu")),
                      ("k3_k5", ("fused_flat.cu", "wilson_normal.cu", "wilson_normal_mixed.cu",
                                 "dslash.cu")), ("k9_k10", ("lb_tiled.cu", "rwkv6.cu")),
                      ("k5l", ("lb.cu",))):
        paths = [os.path.join(csrc, f) for f in srcs]
        if all(map(os.path.exists, paths)):
            libs[tag] = _cuda.BUILD_DIR / f"parent_{tag}.so"
            cmds.append([nvcc, *_cuda.NVCC_FLAGS, "-o", str(libs[tag]), *paths])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [pr.communicate()[0] for pr in procs]
    for c, pr, out in zip(cmds, procs, outs):
        if pr.returncode:
            raise RuntimeError(f"nvcc failed:\n{' '.join(c)}\n{out}")

    def report(out, names):
        lines, keep = [], False
        for ln in out.splitlines():
            if "Compiling entry function" in ln:
                keep = any(n in ln for n in names)
            if keep and ("Compiling entry" in ln or "spill" in ln or "Used" in ln):
                lines.append(ln.split("ptxas info    : ")[-1].strip())
        return lines

    # K5 and K5T's two kernels (SoA, one slot, fp32: K5T is K5's with a walk)
    k5t = ("wilson_normal_t_kernelILi0EiLi1ELb0EfEvPKf",
           "wilson_normal_ap_kernelILi0EiLi1ELb0EfLb0EfEvPKf")
    return {"flash": report(outs[0], (FLASH_MMA,)),
            "k10": report(outs[1], ("rwkv6_",)) + report(outs[2], ("lb_tiled",)),
            "k4_k5l": report(outs[3], ("dslash",))
            + report(outs[4], ("lb_step", "lb_collide", "lb_propagate")),
            "k5t_k3c": report(outs[5], k5t) + report(outs[6], ("lc_chain",))}, libs


def flash_sass(lib):
    """HMMA (bf16 mma.sync) and LDGSTS (cp.async) counts in the SASS of
    each bf16 flash kernel of the built library; raises unless every one
    has both and no other flash kernel takes bf16 (the CUDA-core bf16
    instance is gone)."""
    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            if "rt_flash" in name and "nv_bfloat16" in name:
                counts[name] = {"HMMA.16816.F32.BF16": 0, "LDGSTS": 0}
            else:
                name = None
        elif name is not None:
            for op in counts[name]:
                counts[name][op] += op in ln
    if not counts:
        raise AssertionError("no bf16 flash kernel in the library's SASS")
    for name, c in counts.items():
        if FLASH_MMA not in name or not all(c.values()):
            raise AssertionError(f"{name}: {c} (expected {FLASH_MMA} with HMMA bf16 and LDGSTS)")
    return counts


class ParentKernel:
    """An entry point of the parent's flash.cu, built as a library of its
    own, launched through this tree's wrapper (same C signature)."""

    def __init__(self, lib, name, symbol):
        self.name, self.symbol = name, symbol
        self.fn = getattr(lib, symbol)
        self.fn.argtypes = list(_cuda.SIGNATURES[symbol])
        self.fn.restype = ctypes.c_int

    def launch(self, device, *args):
        rc = self.fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc:
            raise RuntimeError(f"parent {self.symbol}: CUDA error {rc}")


def check_flash_kernels(ptxas, parent_lib):
    """A1: the bf16 kernels' ptxas report and SASS; K11 and K12 against
    their plain versions at starcoder2-7b's heads and at a ragged windowed
    case; timed beside the plain version, scaled_dot_product_attention and,
    where parent_lib is built, the parent's kernels on the same tensors."""
    log("A1: ptxas -v of the bf16 kernels (csrc/flash.cu):\n  " + "\n  ".join(ptxas))
    for name, c in flash_sass(_cuda.build()).items():
        log(f"A1: SASS of {name[:60]}: {c}")
    parent = None
    if parent_lib is not None:
        plib = ctypes.CDLL(str(parent_lib))
        parent = {"flash_attention": ParentKernel(plib, "flash_attention", "rt_flash"),
                  "flash_attention_kvchunk": ParentKernel(plib, "flash_attention_kvchunk",
                                                          "rt_flash_kvchunk")}
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = {}
    cases = (("flash_attention", kf.flash_cuda, kf.flash_plain, (16, 9, 2048, 128)),
             ("flash_attention_kvchunk", kf.flash_kvchunk_cuda, kf.flash_kvchunk_plain,
              (4, 9, 8192, 128)))
    for name, kern, plain, (BKV, rep, S, dh) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((n, S, dh), generator=gen, device="cuda").to(dtype)
                       for n in (BKV * rep, BKV, BKV))
            o = kern(q, k, v, rep=rep)
            want = plain(q, k, v, rep=rep)
            err = flash_err(o, want, f"{name} at {(BKV, rep, S, dh)} {dtype}")
            want_b = want if dtype == torch.bfloat16 else None
            del o, want
            ms = time_ms(lambda: kern(q, k, v, rep=rep))
            log(f"  {name} at (BKV, rep, S, dh) = {(BKV, rep, S, dh)}, causal, {dtype}: max abs "
                f"err {err:.3e}, {ms:.4f} ms")
            if dtype != torch.bfloat16:
                continue
            plain_ms = time_ms(lambda: plain(q, k, v, rep=rep), reps=3, warm=1)
            B = BKV // 4   # starcoder2's 4 kv heads
            q4, k4, v4 = (t.reshape(B, -1, S, dh) for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            library_ms = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True, enable_gqa=True))
            work = flash_work(BKV, rep, S, dh, True, 0, 2)
            add_row(rows, name, err, ms, plain_ms, *work, library_ms=library_ms)
            log(f"  {name}: {work[2] / ms / 1e9:.1f} TFLOP/s of the bound's {work[2] / 1e9:.1f} G "
                f"tensor-core operations, {rows[name]['bound_ms'] / ms:.3f} of the bound, "
                f"{ms / library_ms:.2f}x SDPA")
            if parent is not None:   # the old design, in turns with the new
                extra = (kf.kv_tile(kf.MAX_KV_TILE, S),) if name.endswith("kvchunk") else ()
                old_kern = lambda: kf._launch(parent[name], q, k, v, rep, True, 0, *extra)  # noqa: E731
                err_old = flash_err(old_kern(), want_b, f"parent {name}")
                turns = [time_ms(old_kern), time_ms(lambda: kern(q, k, v, rep=rep)),
                         time_ms(lambda: kern(q, k, v, rep=rep)), time_ms(old_kern)]
                log(f"  {name}: the parent's kernel (err {err_old:.3e}) in turns with this "
                    f"one: {', '.join(f'{t:.4f}' for t in turns)} ms")
            del q4, k4, v4, want_b
        del q, k, v
        torch.cuda.empty_cache()
    # the ragged, windowed case: S 100, a window of 32 (smaller than a kv tile)
    BKV, rep, S, dh, window = 2, 3, 100, 64, 32
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((n, S, dh), generator=gen, device="cuda").to(dtype)
                   for n in (BKV * rep, BKV, BKV))
        e11 = flash_err(kf.flash_cuda(q, k, v, rep=rep, window=window),
                        kf.flash_plain(q, k, v, rep=rep, window=window), "K11 ragged, windowed")
        e12 = max(flash_err(kf.flash_kvchunk_cuda(q, k, v, rep=rep, window=window, kv_block=kvb),
                            kf.flash_kvchunk_plain(q, k, v, rep=rep, window=window,
                                                   kv_block=kvb),
                            f"K12 ragged, windowed, kv_block {kvb}") for kvb in (32, 64))
        log(f"  K11 / K12 at {(BKV, rep, S, dh)}, window {window}, {dtype}: max abs err "
            f"{e11:.3e} / {e12:.3e} (K12 kv tiles of {kf.kv_tile(32, S)} and "
            f"{kf.kv_tile(64, S)})")
    return rows


def matrix_params(params):
    """Entries of the 2-D tensors of a parameter tree: the matmul weights
    (the tied embedding is the logits' matmul)."""
    if isinstance(params, torch.Tensor):
        return params.numel() if params.dim() == 2 else 0
    vals = params.values() if isinstance(params, dict) else params
    return sum(matrix_params(v) for v in vals)


def dense_plain_spread(cfg, params, batch, logits, what):
    """Hold the K11/K12 prefill to PREFILL_SPREAD x the spread of two plain
    prefills that differ only in attention's sum order: at S < 8192 the
    dense branch against the blockwise branch (forced through the port's
    threshold), from 8192 kv_block 1024 against 512.  Returns rel-L2."""
    S = batch["tokens"].shape[1]
    plain = build_prefill(cfg, attn_engine="torch")(params, batch)
    rel, agree = logit_diff(logits, plain)
    threshold = model_attention.BLOCKWISE_MIN_SEQ
    try:
        if S < threshold:
            model_attention.BLOCKWISE_MIN_SEQ = S
            pair = "the blockwise branch against the dense branch"
        else:
            tuning.set_tuning(kv_block=512)
            pair = "kv_block 512 against 1024"
        other = build_prefill(cfg, attn_engine="torch")(params, batch)
    finally:
        model_attention.BLOCKWISE_MIN_SEQ = threshold
        tuning.reset()
    spread, spread_agree = logit_diff(other, plain)
    del plain, other
    log(f"A2: {what}: logits against the plain-attention prefill rel-L2 {rel:.3e}, argmax "
        f"agreement {agree:.4f}; two plain prefills ({pair}) rel-L2 {spread:.3e}, argmax "
        f"agreement {spread_agree:.4f}")
    if not rel <= PREFILL_SPREAD * spread:
        raise AssertionError(f"{what}: prefill logits rel-L2 {rel} > {PREFILL_SPREAD} x the "
                             f"plain prefills' spread {spread}")
    return rel


def dense_prefill():
    """A2: starcoder2-7b at full width prefills 4 x 2048 (K11) and 1 x 8192
    (K12), counted; against the plain-attention prefill in bf16 and on an
    fp32 copy; timed; the first traced."""
    cfg = get_arch("starcoder2-7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n, nbytes = param_stats(params)
    log(f"A2: {cfg.name} initialised on the card in {time.perf_counter() - t0:.1f} s: {n} "
        f"parameters, {nbytes} B")
    if n != DENSE_PARAMS:
        raise AssertionError(f"{cfg.name} has {n} parameters, expected {DENSE_PARAMS}")
    gen = torch.Generator(device="cuda").manual_seed(9)
    batches = [{"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda")}
               for b, s in DENSE_PREFILLS]
    prefill = build_prefill(cfg)
    counts, times = {}, []
    for (b, s), batch in zip(DENSE_PREFILLS, batches):
        reset_counts()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        c = path_counts(FLASH_PATH)
        log(f"A2: prefill {b} x {s} -> logits {tuple(logits.shape)} {logits.dtype}; launches "
            f"on the prefill's path: {c}")
        name = "flash_attention_kvchunk" if s >= model_attention.BLOCKWISE_MIN_SEQ else \
            "flash_attention"
        other = next(k for k in c if k != name)
        if c[name] != cfg.n_layers or c[other]:
            raise AssertionError(f"prefill {b} x {s}: launches {c}, expected {name} once a "
                                 f"layer and {other} never")
        counts[name] = c[name]
        if not torch.isfinite(logits).all():
            raise AssertionError(f"prefill {b} x {s}: non-finite logits")
        dense_plain_spread(cfg, params, batch, logits, f"bf16, {b} x {s}")
        del logits
        ms = time_ms(lambda: prefill(params, batch), reps=3, warm=1)
        times.append(ms)
        log(f"A2: prefill {b} x {s}: {ms:.3f} ms, {b * s / ms * 1e3:.1f} tokens/s")
    p32 = cast_params(params, torch.float32)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    for (b, s), batch in zip(DENSE_PREFILLS, batches):
        rel32 = dense_plain_spread(cfg32, p32, batch, build_prefill(cfg32)(p32, batch),
                                   f"fp32 copy, {b} x {s}")
        if not rel32 < PREFILL_REL_L2_FP32:
            raise AssertionError(f"fp32 prefill {b} x {s}: logits rel-L2 {rel32} >= "
                                 f"{PREFILL_REL_L2_FP32}")
    torch.cuda.empty_cache()
    log(f"A2: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    reset_counts()
    wall, busy, groups = device_profile(
        lambda: prefill(params, batches[0]), "A2: one 4 x 2048 prefill",
        (("flash K11", f"{FLASH_MMA}<false"), ("flash K12", f"{FLASH_MMA}<true")))
    traced = path_counts(FLASH_PATH)
    for group, name in (("flash K11", "flash_attention"), ("flash K12", "flash_attention_kvchunk")):
        if traced[name] and not groups[group] > 0:
            raise AssertionError(f"A2: {name} launched {traced[name]} times in the traced prefill "
                                 f"but its group reads {groups[group]} ms: is {FLASH_MMA} renamed?")
    log(f"A2: K11 in the traced 4 x 2048 prefill: {groups['flash K11']:.3f} ms, "
        f"{groups['flash K11'] / wall:.3f} of the host clock, {groups['flash K11'] / busy:.3f} "
        f"of the kernels' time")
    b, s = DENSE_PREFILLS[0]
    flops = 2 * b * s * matrix_params(params)
    log(f"A2: the 4 x 2048 prefill's matmuls: {flops / 1e12:.2f} TFLOP in {groups['matmul']:.3f} "
        f"ms, {flops / groups['matmul'] / 1e9:.1f} TFLOP/s")
    return cfg, params, p32, nbytes, counts, times


def dense_serve(cfg, params, p32, nbytes):
    """A3: generate for SERVE_B requests over a DENSE_S_MAX cache; the fp32
    decode after the prompt against the fp32 prefill's last position."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    prompt = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_PROMPT), generator=gen, device="cuda")
    generate(params, cfg, prompt[:, :2], steps=2, s_max=DENSE_S_MAX)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(params, cfg, prompt, steps=SERVE_NEW, s_max=DENSE_S_MAX)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = SERVE_PROMPT + SERVE_NEW
    cache_bytes = 2 * cfg.n_layers * SERVE_B * DENSE_S_MAX * cfg.n_kv_heads * cfg.head_dim * 2
    bound_ms = (nbytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"A3: generate {SERVE_B} requests, prompt {SERVE_PROMPT}, {SERVE_NEW} new tokens, "
        f"cache {DENSE_S_MAX}: {dt:.3f} s, {steps} decode steps, {dt / steps * 1e3:.3f} ms a step "
        f"(bound {bound_ms:.3f} ms: {nbytes} B of weights + {cache_bytes} B of k/v cache), "
        f"{SERVE_B * SERVE_NEW / dt:.1f} new tokens/s")
    log(f"A3: first request's new tokens {out[0, SERVE_PROMPT:].tolist()}")
    if tuple(out.shape) != (SERVE_B, steps) or not torch.equal(out[:, :SERVE_PROMPT], prompt):
        raise AssertionError(f"generate returned {tuple(out.shape)} without the prompt first")
    if not (0 <= int(out.min()) and int(out.max()) < cfg.vocab):
        raise AssertionError("generated tokens outside the vocab")
    step = build_serve_step(cfg)
    with torch.inference_mode():
        cache = init_cache(cfg, SERVE_B, DENSE_S_MAX, device="cuda")
        device_profile(lambda: step(params, cache, out[:, 0]), "A3: one decode step",
                       (("flash", "rt_flash_"),))
        del cache
    # fp32: the decode after the prompt against the prefill's last position
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    pre = build_prefill(cfg32)(p32, {"tokens": prompt})[:, -1]
    step32 = build_serve_step(cfg32)
    with torch.inference_mode():
        cache = init_cache(cfg32, SERVE_B, DENSE_S_MAX, device="cuda")
        for t in range(SERVE_PROMPT):
            logits, cache = step32(p32, cache, prompt[:, t])
        del cache
    rel, agree = logit_diff(logits, pre)
    log(f"A3: fp32 decode after the prompt against the prefill's last position: rel-L2 "
        f"{rel:.3e}, argmax agreement {agree:.4f}")
    if not rel < DECODE_REL_L2_FP32:
        raise AssertionError(f"fp32 decode logits rel-L2 {rel} >= {DECODE_REL_L2_FP32}")
    return dt / steps * 1e3, bound_ms


# -- K1 and K2 in turns with the parent's design (Q1, Q2) -----------------------------

# the parent's K1 and K2 entry points, which take this tree's C signatures
PARENT_K12 = ("rt_site_g5", "rt_site_mul", "rt_reduce_partials_batched",
              "rt_reduce_fold_batched", "rt_reduce_partials_comp", "rt_reduce_fold_comp")


class ParentK12:
    """The parent's K1 and K2 (its site_local.cu and reduce.cu, built with
    its own headers as a library of their own), launched on SoA fields with
    the kernels' own arguments: partial tables of partial_rows(nsites) rows
    and pass 2's scratch, as core/reduce.py sizes them."""

    def __init__(self, path, vvl):
        lib = ctypes.CDLL(str(path))
        self.vvl, self.fn = vvl, {}
        for name in PARENT_K12:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(_cuda.SIGNATURES[name]), ctypes.c_int
            self.fn[name] = fn

    def _call(self, name, *args):
        rc = self.fn[name](*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent {name}: CUDA error {rc}")

    def g5(self, x, flip):
        out = torch.empty_like(x)
        self._call("rt_site_g5", x.data_ptr(), out.data_ptr(), *x.shape, flip, 0, 0)
        return out

    def mul(self, x, y):
        """x, y: (ncomp, nsites), or (batch, ncomp, nsites) both."""
        ncomp, nsites = x.shape[-2:]
        batch, stride = (x.shape[0], ncomp * nsites) if x.dim() == 3 else (1, 0)
        out = torch.empty_like(x)
        self._call("rt_site_mul", x.data_ptr(), y.data_ptr(), out.data_ptr(), ncomp, nsites,
                   batch, stride, stride, 0, 0, 0)
        return out

    def fold(self, partials, compensated=False):
        """(batch, nrows, ncomp[, 2]) -> (batch, ncomp)."""
        batch, nrows, ncomp = partials.shape[:3]
        words = 2 if compensated else 1
        out = torch.empty((batch, ncomp), device=partials.device)
        scratch = torch.empty(max(1, batch * words * reduce.fold_scratch(nrows, ncomp)),
                              device=partials.device)
        if compensated:
            self._call("rt_reduce_fold_comp", partials.data_ptr(), out.data_ptr(),
                       scratch.data_ptr(), nrows, ncomp, batch)
        else:
            self._call("rt_reduce_fold_batched", partials.data_ptr(), out.data_ptr(),
                       scratch.data_ptr(), nrows, ncomp, batch, 0)
        return out

    def sum(self, x, compensated=False):
        """(batch, ncomp, nsites) -> (batch, ncomp), both passes."""
        batch, ncomp, nsites = x.shape
        shape = (batch, reduce.partial_rows(nsites), ncomp) + ((2,) if compensated else ())
        partials = torch.empty(shape, device=x.device)
        if compensated:
            self._call("rt_reduce_partials_comp", x.data_ptr(), partials.data_ptr(), ncomp,
                       nsites, batch, 0)
        else:
            self._call("rt_reduce_partials_batched", x.data_ptr(), partials.data_ptr(), ncomp,
                       nsites, batch, 0, 0)
        return self.fold(partials, compensated)


def graph_ms(fn):
    """Median device time of fn()'s launches replayed from a CUDA graph:
    the kernels alone, without the host's Python between them (a call
    timed by time_ms includes it, which is most of a fold's time)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(graph.replay)
    del graph
    torch.cuda.empty_cache()
    return ms


def redesign_turns(cases, graphs=True):
    """Each case: name -> (this tree's call, the parent's, the library
    call or None, bytes, flops, check(parent's out, this out)).  Checks the
    parent's output against this tree's, then times parent, this, this,
    parent on the same tensors, and the library call, each a call at a
    time (time_ms) and, with ``graphs``, replayed from a CUDA graph
    (graph_ms, the same order); returns the rows."""
    rows = {}
    for name, (this, old, lib, nbytes, flops, check) in cases.items():
        check(old(), this())
        t = [time_ms(old), time_ms(this), time_ms(this), time_ms(old)]
        lib_ms = time_ms(lib) if lib else None
        if not graphs:
            b_ms, b_by = bound(nbytes, flops)
            ms = statistics.median(t[1:3])
            rows[name] = dict(parent_ms=[t[0], t[3]], ms=t[1:3], library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by)
            log(f"  {name:28s} parent {t[0]:.4f}, this {t[1]:.4f}, {t[2]:.4f}, parent "
                f"{t[3]:.4f} ms; bound {b_ms:.4f} ({b_by}): {b_ms / ms:.3f} of it, "
                f"{statistics.median([t[0], t[3]]) / ms:.2f}x faster than the parent")
            continue
        g = [graph_ms(old), graph_ms(this), graph_ms(this), graph_ms(old)]
        g_lib = graph_ms(lib) if lib else None
        b_ms, b_by = bound(nbytes, flops)
        ms, gms = statistics.median(t[1:3]), statistics.median(g[1:3])
        rows[name] = dict(parent_ms=[t[0], t[3]], ms=t[1:3], library_ms=lib_ms,
                          graph_parent_ms=[g[0], g[3]], graph_ms=g[1:3], graph_library_ms=g_lib,
                          bound_ms=b_ms, bound_by=b_by)
        vs_lib = (f"; library {lib_ms:.4f} ({ms / lib_ms:.2f}x it), from a graph {g_lib:.4f} "
                  f"({gms / g_lib:.2f}x it)" if lib else "")
        log(f"  {name:28s} parent {t[0]:.4f}, this {t[1]:.4f}, {t[2]:.4f}, parent {t[3]:.4f} "
            f"ms; bound {b_ms:.4f} ({b_by}): {b_ms / ms:.3f} of it, "
            f"{statistics.median([t[0], t[3]]) / ms:.2f}x faster than the parent; from a CUDA "
            f"graph: parent {g[0]:.4f}, this {g[1]:.4f}, {g[2]:.4f}, parent {g[3]:.4f} ms "
            f"({b_ms / gms:.3f} of the bound){vs_lib}")
    return rows


def _bits_check(name):
    return lambda old, new: bits_err(old.reshape(new.shape), new, f"{name}: parent vs this")


def _sum_check(name, terms):
    return lambda old, new: sum_err(old.reshape(new.shape), new, terms, f"{name}: parent vs this")


def _oracle_check(name, terms):
    """Both compensated folds within the oracle bound (terms: (..., ncomp,
    sites), checked a slot at a time)."""
    def check(old, new):
        for o, n, t in zip(old.reshape(new.shape).reshape(-1, new.shape[-1]),
                           new.reshape(-1, new.shape[-1]), terms.reshape(-1, *terms.shape[-2:])):
            oracle_err(o, t, f"{name} (parent)")
            oracle_err(n, t, name)
    return check


def milc_turns(parent, b, vvl):
    """Q1: K1 and K2 at phase 3's shapes (g5, the product, the sum, the fold
    of a fused kernel's table), S1's (4 slots: dot_prod, the batched sum
    and fold) and P1's (the compensated fold, single and batched), in turns
    with the parent's design."""
    V, dev = b.nsites, b.data.device
    gen = torch.Generator(device=dev).manual_seed(3)
    psi = b.data
    y = torch.randn((24, V), generator=gen, device=dev)
    sign = torch.ones((24, 1), device=dev)
    sign[12:] = -1.0
    prod = psi * y
    nb = -(-V // vvl)
    parts = torch.randn((nb, 24), generator=gen, device=dev)
    pairs = reduce.fold_pairs(nb, 24, dev)
    x4, r4 = torch.stack([psi, y, psi, y]), torch.stack([y, psi, psi, y])
    prod4 = x4 * r4
    parts4, pairs4 = torch.stack([parts * (k + 1) for k in range(SLOTS)]), torch.stack([pairs] * SLOTS)
    pair_terms = pairs.permute(1, 0, 2).reshape(24, -1)
    cases = {
        "g5": (lambda: target.site_g5(psi, 12, vvl), lambda: parent.g5(psi, 12),
               lambda: torch.mul(psi, sign), 2 * 96 * V, 12 * V, _bits_check("g5")),
        "mul": (lambda: target.site_mul(psi, y, vvl), lambda: parent.mul(psi, y),
                lambda: torch.mul(psi, y), 3 * 96 * V, 24 * V, _bits_check("mul")),
        "dot_prod": (lambda: target.site_mul(x4, r4, vvl, batch=SLOTS),
                     lambda: parent.mul(x4, r4), lambda: torch.mul(x4, r4),
                     SLOTS * 3 * 96 * V, SLOTS * 24 * V, _bits_check("dot_prod")),
        "reduce_sum": (lambda: reduce.reduce_sites(prod, "sum", vvl),
                       lambda: parent.sum(prod[None]), lambda: torch.sum(prod, dim=1),
                       96 * V, 24 * V, _sum_check("reduce_sum", prod)),
        "reduce_fold": (lambda: reduce.fold_partials(parts, "sum"),
                        lambda: parent.fold(parts[None]), lambda: torch.sum(parts, dim=0),
                        parts.numel() * 4 + 96, parts.numel(), _sum_check("reduce_fold", parts.T)),
        "reduce_sum_batched": (lambda: reduce.reduce_sites_batched(prod4, "sum", vvl),
                               lambda: parent.sum(prod4), lambda: torch.sum(prod4, dim=-1),
                               SLOTS * 96 * V, SLOTS * 24 * V,
                               _sum_check("reduce_sum_batched", prod4)),
        "reduce_fold_batched": (lambda: reduce.fold_partials_batched(parts4, "sum"),
                                lambda: parent.fold(parts4), lambda: torch.sum(parts4, dim=1),
                                parts4.numel() * 4 + SLOTS * 96, parts4.numel(),
                                _sum_check("reduce_fold_batched", parts4.transpose(1, 2))),
        "reduce_fold_comp": (lambda: reduce.fold_partials(pairs, "sum", compensated=True),
                             lambda: parent.fold(pairs[None], True),
                             lambda: torch.sum(pairs, dim=(0, 2), dtype=torch.float64),
                             pairs.numel() * 4 + 96, pairs.numel(),
                             _oracle_check("reduce_fold_comp", pair_terms)),
        "reduce_fold_comp_batched": (
            lambda: reduce.fold_partials_batched(pairs4, "sum", compensated=True),
            lambda: parent.fold(pairs4, True),
            lambda: torch.sum(pairs4, dim=(1, 3), dtype=torch.float64),
            pairs4.numel() * 4 + SLOTS * 96, pairs4.numel(),
            _oracle_check("reduce_fold_comp_batched", torch.stack([pair_terms] * SLOTS))),
    }
    log(f"Q1: K1 and K2 at {tuple(b.lattice)} in turns with the parent's design:")
    rows = redesign_turns(cases)
    del y, prod, parts, pairs, x4, r4, prod4, parts4, pairs4, pair_terms, cases
    torch.cuda.empty_cache()
    return rows


def ludwig_turns(parent, state, vvl):
    """Q2: K2 at L2's shapes (the sum of dist, the fold of a fused kernel's
    table) and P1's (the compensated sum of dist), in turns with the
    parent's design."""
    V, dev = state.q.nsites, state.q.data.device
    gen = torch.Generator(device=dev).manual_seed(4)
    dist = state.dist.canonical() * (1.0 + 0.05 * torch.randn((19, V), generator=gen, device=dev))
    parts = torch.randn((-(-V // vvl), 19), generator=gen, device=dev)
    cases = {
        "ludwig_reduce_sum": (lambda: reduce.reduce_sites(dist, "sum", vvl),
                              lambda: parent.sum(dist[None]), lambda: torch.sum(dist, dim=1),
                              76 * V, 19 * V, _sum_check("ludwig_reduce_sum", dist)),
        "ludwig_reduce_fold": (lambda: reduce.fold_partials(parts, "sum"),
                               lambda: parent.fold(parts[None]), lambda: torch.sum(parts, dim=0),
                               parts.numel() * 4 + 76, parts.numel(),
                               _sum_check("ludwig_reduce_fold", parts.T)),
        "reduce_sum_comp": (lambda: reduce.reduce_sites(dist, "sum", vvl, compensated=True),
                            lambda: parent.sum(dist[None], True),
                            lambda: torch.sum(dist, dim=1, dtype=torch.float64), 76 * V, 19 * V,
                            _oracle_check("reduce_sum_comp", dist)),
    }
    log(f"Q2: K2 at {tuple(state.q.lattice)} in turns with the parent's design:")
    rows = redesign_turns(cases)
    del dist, parts, cases
    torch.cuda.empty_cache()
    return rows


# -- K3 and K5 in turns with the parent's design (Q3) --------------------------------

K35_SYMBOLS = ("rt_cg_update", "rt_cg_update_masked", "rt_cg_update_ap16", "rt_cg_xpay",
               "rt_cg_xpay_masked", "rt_wilson_normal_t_batched", "rt_wilson_normal_ap_batched",
               "rt_wilson_normal_t_mixed", "rt_wilson_normal_ap_mixed", "rt_dslash")
# milc_small's V at x-reuse distances of 32,768 and 8,192 sites (131,072 at milc_small)
Q3_REUSE_LATTICES = ((256, 32, 32, 32), (1024, 16, 16, 32))
NORMAL_FLOPS = 2 * (1320 + 48) + 48    # K5's flops a site (phase 3)
# K5's two-launch design floor, bytes a site: the t launch (p, u in, t out),
# the ap launch (t, u, p in, ap out); a slot's p, t, ap and one u a launch
# at 4 slots; the policy instance with a bf16 u and ap
NORMAL_FLOOR = {"wilson_normal": 480 + 576, "wilson_normal_batched": 4 * 192 + 288 + 4 * 288 + 288,
                "wilson_normal_policy": 336 + 384,
                "wilson_normal_batched_policy": 4 * 192 + 144 + 4 * 240 + 144}


class K35:
    """K3's, K4's and K5's entry points of one library (this tree's, or the
    parent's built beside phase 2's build: the same C signatures), launched
    on the caller's tensors with the kernels' own arguments and partial
    tables, outside the launch counts."""

    def __init__(self, lib, label):
        self.label, self.fn = label, {}
        for name in K35_SYMBOLS:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(_cuda.SIGNATURES[name]), ctypes.c_int
            self.fn[name] = fn

    def _call(self, name, *args):
        rc = self.fn[name](*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.label} {name}: CUDA error {rc}")

    def xpay(self, x, y, a, vvl, m=None):
        """y + a x; x, y: (24, V) SoA, or (batch, 24, V) both with m."""
        out = torch.empty_like(y)
        ncomp, V = y.shape[-2:]
        if m is None:
            self._call("rt_cg_xpay", x.data_ptr(), y.data_ptr(), a.data_ptr(), out.data_ptr(),
                       ncomp, V, 0, 0, 0, vvl)
        else:
            self._call("rt_cg_xpay_masked", x.data_ptr(), y.data_ptr(), a.data_ptr(),
                       m.data_ptr(), out.data_ptr(), ncomp, V, m.numel(), ncomp * V,
                       ncomp * V, 0, 0, 0, vvl)
        return out

    def update(self, x, r, p, ap, a, na, V, vvl, lay=SOA, m=None):
        """(x_new, r_new, partials) of fields physical in ``lay`` over V
        sites (stacked, with m: (batch,)); ap fp32 or bf16."""
        d = lay.descriptor()
        x_new, r_new = torch.empty_like(x), torch.empty_like(r)
        lead = (m.numel(),) if m is not None else ()
        parts = torch.empty(lead + (-(-V // vvl), 24), device=x.device)
        ptrs = (x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(), a.data_ptr(),
                na.data_ptr())
        if m is None:
            name = "rt_cg_update_ap16" if ap.dtype == torch.bfloat16 else "rt_cg_update"
            self._call(name, *ptrs, x_new.data_ptr(), r_new.data_ptr(), parts.data_ptr(), V,
                       *(d,) * 6, vvl)
        else:
            self._call("rt_cg_update_masked", *ptrs, m.data_ptr(), x_new.data_ptr(),
                       r_new.data_ptr(), parts.data_ptr(), V, m.numel(), *(24 * V,) * 4,
                       *(d,) * 6, vvl)
        return x_new, r_new, parts

    def normal(self, p, u, lattice, vvl, lay=SOA, policy=None):
        """K5's two launches on p (batch, 24, V) physical in ``lay`` ->
        (t, ap, partials (batch, ceil(V / vvl), 24[, 2])); ``policy``
        (bf16, comp): the policy instance (u bf16 where this tree takes it)."""
        batch, V = p.shape[0], math.prod(lattice)
        d = lay.descriptor()
        bf16, comp = policy or (False, False)
        t = torch.empty((batch, 24, V), device=p.device)
        ap = torch.empty(p.shape, device=p.device,
                         dtype=torch.bfloat16 if bf16 else torch.float32)
        parts = torch.empty((batch, -(-V // vvl), 24) + ((2,) if comp else ()), device=p.device)
        t_name = "rt_wilson_normal_t_mixed" if bf16 else "rt_wilson_normal_t_batched"
        self._call(t_name, p.data_ptr(), u.data_ptr(), t.data_ptr(), KAPPA, *lattice, batch, d,
                   d, vvl)
        if policy:
            self._call("rt_wilson_normal_ap_mixed", p.data_ptr(), t.data_ptr(), u.data_ptr(),
                       ap.data_ptr(), parts.data_ptr(), KAPPA, *lattice, batch, int(bf16),
                       int(comp), d, d, d, vvl)
        else:
            self._call("rt_wilson_normal_ap_batched", p.data_ptr(), t.data_ptr(), u.data_ptr(),
                       ap.data_ptr(), parts.data_ptr(), KAPPA, *lattice, batch, d, d, d, vvl)
        return t, ap, parts

    def dslash(self, psi, u, lattice, vvl, lay=SOA):
        """K4 on psi and u physical in ``lay``."""
        out = torch.empty_like(psi)
        d = lay.descriptor()
        self._call("rt_dslash", psi.data_ptr(), u.data_ptr(), out.data_ptr(), *lattice, d, d, d,
                   vvl)
        return out


def _all_bits(name):
    """Every tensor of the parent's output tuple bitwise this tree's."""
    def check(old, new):
        for k, (o, n) in enumerate(zip(old, new)):
            bits_err(o.reshape(n.shape), n, f"{name} [{k}]: parent vs this")
    return check


def k3_k5_turns(parent, u, b, lattice, vvl):
    """Q3: K3 (cg_xpay; cg_update in SoA, AoS and aosoa4, fed a bf16 ap;
    both masked over 4 slots) and K5 (SoA, AoS, aosoa16, 4 slots, the policy
    instance single and over 4 slots) at phase 3's shapes, bitwise the
    parent's design and timed in turns with it, a call at a time and from a
    CUDA graph, K5 beside its two-launch design floor; then K5 and K4 (in
    turns) at Q3_REUSE_LATTICES on random fields, shorter x-reuse distances,
    and a 1 GiB device copy.  Returns the rows."""
    this = K35(_cuda.library(), "this")
    V, dev = b.nsites, b.data.device
    gen = torch.Generator(device=dev).manual_seed(5)
    x, r, p, ap = (torch.randn((24, V), generator=gen, device=dev) for _ in range(4))
    a = torch.tensor(0.37, device=dev)
    na = -a
    lays = {n: parse_layout(n) for n in ("aos", "aosoa4", "aosoa16")}
    cases = {
        "cg_xpay": (lambda: this.xpay(p, r, a, vvl), lambda: parent.xpay(p, r, a, vvl),
                    lambda: torch.addcmul(r, a, p), 288 * V, 48 * V, _bits_check("cg_xpay")),
        "cg_update": (lambda: this.update(x, r, p, ap, a, na, V, vvl),
                      lambda: parent.update(x, r, p, ap, a, na, V, vvl), None, 576 * V,
                      144 * V, _all_bits("cg_update")),
    }
    ap16 = ap.to(torch.bfloat16)
    cases["cg_update_ap16"] = (lambda: this.update(x, r, p, ap16, a, na, V, vvl),
                               lambda: parent.update(x, r, p, ap16, a, na, V, vvl), None,
                               528 * V, 144 * V, _all_bits("cg_update_ap16"))
    log(f"Q3: K3 at {tuple(lattice)} in turns with the parent's design:")
    rows = redesign_turns(cases)
    del cases, ap16
    for spec in ("aos", "aosoa4"):
        lay = lays[spec]
        xl, rl, pl, apl = (lay.pack(t) for t in (x, r, p, ap))
        rows.update(redesign_turns({f"cg_update@{spec}": (
            lambda: this.update(xl, rl, pl, apl, a, na, V, vvl, lay),
            lambda: parent.update(xl, rl, pl, apl, a, na, V, vvl, lay), None, 576 * V, 144 * V,
            _all_bits(f"cg_update@{spec}"))}))
        del xl, rl, pl, apl
        torch.cuda.empty_cache()
    # 4 slots, mask 1, 0, 1, 0 (a frozen slot reads no p, ap or x)
    m = torch.tensor([1.0, 0.0, 1.0, 0.0], device=dev)
    a4 = torch.tensor([0.37, -1.5, 0.25, 2.0], device=dev)
    x4, r4, p4, ap4 = (torch.stack([t, t.flip(0), t * 0.5, t]) for t in (x, r, p, ap))
    del x, r, ap
    rows.update(redesign_turns({
        "cg_xpay_masked": (lambda: this.xpay(p4, r4, a4, vvl, m),
                           lambda: parent.xpay(p4, r4, a4, vvl, m), None,
                           (2 * 288 + 2 * 192) * V, 2 * 48 * V, _bits_check("cg_xpay_masked")),
        "cg_update_masked": (lambda: this.update(x4, r4, p4, ap4, a4, -a4, V, vvl, m=m),
                             lambda: parent.update(x4, r4, p4, ap4, a4, -a4, V, vvl, m=m), None,
                             (2 * 576 + 2 * 384) * V, 2 * 144 * V,
                             _all_bits("cg_update_masked"))}))
    del x4, r4, p4, ap4
    torch.cuda.empty_cache()
    # K5: the policy instances of both trees read the operator's bf16 copy of u
    u32 = u.data
    u16 = wk.bf16_pack_cuda(u32)
    p1, p4 = p[None], torch.stack([p, p.flip(0), p * 0.5, -p])
    cases = {
        "wilson_normal": (lambda: this.normal(p1, u32, lattice, vvl),
                          lambda: parent.normal(p1, u32, lattice, vvl), None, 480 * V,
                          NORMAL_FLOPS * V, _all_bits("wilson_normal")),
        "wilson_normal_batched": (lambda: this.normal(p4, u32, lattice, vvl),
                                  lambda: parent.normal(p4, u32, lattice, vvl), None,
                                  (4 * 96 + 288 + 4 * 96) * V, 4 * NORMAL_FLOPS * V,
                                  _all_bits("wilson_normal_batched")),
        "wilson_normal_policy": (lambda: this.normal(p1, u16, lattice, vvl, policy=(True, True)),
                                 lambda: parent.normal(p1, u16, lattice, vvl,
                                                       policy=(True, True)),
                                 None, (96 + 144 + 48) * V, NORMAL_FLOPS * V,
                                 _all_bits("wilson_normal_policy")),
        "wilson_normal_batched_policy": (
            lambda: this.normal(p4, u16, lattice, vvl, policy=(True, True)),
            lambda: parent.normal(p4, u16, lattice, vvl, policy=(True, True)), None,
            (4 * 96 + 144 + 4 * 48) * V, 4 * NORMAL_FLOPS * V,
            _all_bits("wilson_normal_batched_policy")),
    }
    log(f"Q3: K5 at {tuple(lattice)} in turns with the parent's design:")
    rows.update(redesign_turns(cases))
    del cases, p4, u16
    torch.cuda.empty_cache()
    for name, nb in NORMAL_FLOOR.items():
        floor = bound(nb * V, 0)[0]
        rows[name]["design_floor_ms"] = floor
        log(f"  {name}: {floor / statistics.median(rows[name]['ms']):.3f} of the two-launch "
            f"design floor {floor:.4f} ms ({nb} B a site), from a CUDA graph "
            f"{floor / statistics.median(rows[name]['graph_ms']):.3f}")
    for spec in ("aos", "aosoa16"):
        lay = lays[spec]
        pl, ul = lay.pack(p)[None], lay.pack(u32)
        rows.update(redesign_turns({f"wilson_normal@{spec}": (
            lambda: this.normal(pl, ul, lattice, vvl, lay),
            lambda: parent.normal(pl, ul, lattice, vvl, lay), None, 480 * V, NORMAL_FLOPS * V,
            _all_bits(f"wilson_normal@{spec}"))}))
        del pl, ul
        torch.cuda.empty_cache()
    del p, p1
    rows.update(k4_turns(this, parent, u32, b, lattice, vvl))
    # the reuse distance: K5 and K4 (in turns) at Q3_REUSE_LATTICES, random fields
    for lat2 in Q3_REUSE_LATTICES:
        V2 = math.prod(lat2)
        ur = torch.randn((72, V2), generator=gen, device=dev) * 0.2
        pr = torch.randn((1, 24, V2), generator=gen, device=dev)
        tag = "x".join(map(str, lat2))
        log(f"Q3: K5 and K4 at {lat2} (x-reuse {lat2[1] * lat2[2] * lat2[3]} sites), "
            f"random fields:")
        rows.update(redesign_turns({
            f"wilson_normal@{tag}": (lambda: this.normal(pr, ur, lat2, vvl),
                                     lambda: parent.normal(pr, ur, lat2, vvl), None, 480 * V2,
                                     NORMAL_FLOPS * V2, _all_bits(f"wilson_normal@{tag}")),
            f"dslash@{tag}": (lambda: this.dslash(pr[0], ur, lat2, vvl),
                              lambda: parent.dslash(pr[0], ur, lat2, vvl), None, 480 * V2,
                              1320 * V2, _bits_check(f"dslash@{tag}"))}))
        del ur, pr
        torch.cuda.empty_cache()
    # the rate a plain stream reaches: a device-to-device copy of 1 GiB
    src = torch.empty(2 ** 28, device=dev)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src))
    rows["device_copy_1gib"] = {"ms": copy_ms, "tb_per_s": 2 * 2 ** 30 / copy_ms / 1e9}
    log(f"Q3: a 1 GiB device copy {copy_ms:.4f} ms, "
        f"{rows['device_copy_1gib']['tb_per_s']:.3f} TB/s read + written")
    del src, dst
    torch.cuda.empty_cache()
    return rows


def k4_turns(this, parent, u, b, lattice, vvl):
    """Q3: K4 at phase 3's lattice in SoA, AoS, aosoa4 and aosoa16, this
    tree's design against the parent's: out bitwise the parent's, timed in
    turns as Q1.  Returns the rows (dslash, dslash@<layout>)."""
    rows = {}
    V = b.nsites
    for spec in ("soa", "aos", "aosoa4", "aosoa16"):
        lay = parse_layout(spec)
        pl, ul = lay.pack(b.data), lay.pack(u)
        name = "dslash" if spec == "soa" else f"dslash@{spec}"
        log(f"Q3: K4 at {tuple(lattice)} in {spec} in turns with the parent's design:")
        rows.update(redesign_turns({name: (
            lambda: this.dslash(pl, ul, lattice, vvl, lay),
            lambda: parent.dslash(pl, ul, lattice, vvl, lay), None, 480 * V, 1320 * V,
            _bits_check(name))}))
        del pl, ul
        torch.cuda.empty_cache()
    return rows


# -- K7, K8 and K5L in turns with the parent's design (Q5) ------------------------------

class LbStep:
    """K7's, K8's and K5L's entry points of one library (this tree's, or the
    parent's lb.cu built beside phase 2's build: the same C signatures),
    launched on the caller's tensors outside the launch counts."""

    SYMBOLS = ("rt_lb_collide", "rt_lb_propagate", "rt_lb_step", "rt_lb_step_bf16")

    def __init__(self, lib, label):
        self.label, self.fn = label, {}
        for name in self.SYMBOLS:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(_cuda.SIGNATURES[name]), ctypes.c_int
            self.fn[name] = fn

    def _call(self, name, *args):
        rc = self.fn[name](*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.label} {name}: CUDA error {rc}")

    def collide(self, dist, force, tau, V, vvl, lay):
        """K7's out, physical in ``lay`` (dist and force in it too)."""
        out = torch.empty_like(dist)
        d = lay.descriptor()
        self._call("rt_lb_collide", dist.data_ptr(), force.data_ptr(), out.data_ptr(), V,
                   *k7.lb_params(float(tau)), d, d, d, vvl)
        return (out,)

    def propagate(self, dist, lat, vvl, lay):
        """K8's out, physical in ``lay``."""
        out = torch.empty_like(dist)
        d = lay.descriptor()
        self._call("rt_lb_propagate", dist.data_ptr(), out.data_ptr(), *lat, d, d, vvl)
        return (out,)

    def step(self, dist, force, tau, lat, vvl, lay, with_u=True, bf16=False):
        """(dist2, u or None) physical in ``lay``; ``bf16``: the policy
        instance."""
        V, dt = math.prod(lat), torch.bfloat16 if bf16 else torch.float32
        dist2 = torch.empty(lay.physical_shape(19, V), dtype=dt, device=dist.device)
        u = torch.empty(lay.physical_shape(3, V), dtype=dt, device=dist.device) if with_u else None
        d = lay.descriptor()
        self._call("rt_lb_step_bf16" if bf16 else "rt_lb_step", dist.data_ptr(),
                   force.data_ptr(), dist2.data_ptr(), u.data_ptr() if with_u else None, *lat,
                   *k7.lb_params(float(tau)), d, d, d, d, vvl)
        return (dist2, u) if with_u else (dist2,)


def _pinned_check(name, plain, bf16=False):
    """A collision output after the pin (csrc/d3q19.cuh): output 0 bitwise
    the plain version on the card and within FIELD_RTOL x max|plain| of the
    parent's (``bf16``: within one bf16 ulp of it); every other output
    bitwise the parent's."""
    def check(old, new):
        bits_err(new[0], plain, f"{name}: this vs the plain version")
        (bf16_err if bf16 else field_err)(new[0].float(), old[0].float().reshape(new[0].shape),
                                          f"{name}: this vs the parent")
        for k, (o, n) in enumerate(zip(old[1:], new[1:]), 1):
            bits_err(o.reshape(n.shape), n, f"{name} [{k}]: parent vs this")
    return check


def k5l_turns(parent, state, cfg, vvl):
    """Q5 (after L2): K7, K8 and K5L (ludwig_lb_step, lb_collide_propagate
    and the policy instance) at L2's lattice and inputs in SoA, AoS, aosoa4
    and aosoa16, this tree's against the parent's lb.cu: K8 and K5L's u
    bitwise the parent's, K7 and K5L's dist2 bitwise the plain version on
    the card and within tolerance of the parent's (:func:`_pinned_check`),
    timed in turns (parent, this, this, parent), a call at a time, K8 beside
    ``torch.take``.  Returns the rows (name@layout; SoA unsuffixed)."""
    this = LbStep(_cuda.library(), "this")
    lat, tau = cfg.lattice, cfg.tau
    V = math.prod(lat)
    inp = ludwig_inputs(state, vvl)
    dist, force = inp["dist"], inp["force"]
    del inp
    rows = {}
    for spec in ("soa", "aos", "aosoa4", "aosoa16"):
        lay = parse_layout(spec)
        d, f = lay.pack(dist), lay.pack(force)
        tag = "" if spec == "soa" else f"@{spec}"
        c = k7.collide_plain(d, f, tau, {"dist": lay, "force": lay})
        plain2 = k8.propagate_plain(c, lat, {"dist": lay})
        plain16 = k8.lb_step_plain(d, f, tau, lat, with_u=False, bf16=True,
                                   layouts={"dist": lay, "force": lay})[0]
        idx = take_index(lat, lay, d.device)
        cases = {
            "lb_collide" + tag: (lambda: this.collide(d, f, tau, V, vvl, lay),
                                 lambda: parent.collide(d, f, tau, V, vvl, lay), None, 164 * V,
                                 FLOPS["collide"] * V, _pinned_check("lb_collide" + tag, c)),
            "lb_propagate" + tag: (lambda: this.propagate(c, lat, vvl, lay),
                                   lambda: parent.propagate(c, lat, vvl, lay),
                                   lambda: torch.take(c, idx), 152 * V, 0,
                                   _all_bits("lb_propagate" + tag))}
        for name, with_u, bf16, nbytes, flops in (
                ("lb_step", True, False, 176, FLOPS["lb_step"]),
                ("lb_collide_propagate", False, False, 164, FLOPS["collide"]),
                ("lb_step_policy", True, True, 132, FLOPS["lb_step"])):
            kw = dict(with_u=with_u, bf16=bf16)
            cases[name + tag] = (
                lambda kw=kw: this.step(d, f, tau, lat, vvl, lay, **kw),
                lambda kw=kw: parent.step(d, f, tau, lat, vvl, lay, **kw), None, nbytes * V,
                flops * V, _pinned_check(name + tag, plain16 if bf16 else plain2, bf16))
        log(f"Q5: K7, K8 and K5L at {tuple(lat)} in {spec} in turns with the parent's design:")
        rows.update(redesign_turns(cases, graphs=False))
        del d, f, c, plain2, plain16, idx, cases
        torch.cuda.empty_cache()
    del dist, force
    torch.cuda.empty_cache()
    return rows


# -- K9 and K10 in turns with the parent's design (Q4) --------------------------------

class ParentK9K10:
    """The parent's K9 (lb_tiled.cu) and K10 (rwkv6.cu: the state pass and
    the output pass), built with its own headers as a library of their own,
    launched through this tree's C signatures outside the launch counts."""

    def __init__(self, path):
        lib = ctypes.CDLL(str(path))
        self.fn = {}
        # a parent whose K9 takes layout descriptors has its bf16 instance beside it;
        # an older one takes SoA fields and no descriptors
        self.layouts = hasattr(lib, "rt_lb_step_tiled_bf16")
        for name in ("rt_lb_step_tiled", "rt_rwkv6_state", "rt_rwkv6_output"):
            fn = getattr(lib, name)
            sig = _cuda.SIGNATURES[name]
            if name == "rt_lb_step_tiled" and not self.layouts:
                sig = sig[:14] + sig[18:]
            fn.argtypes, fn.restype = list(sig), ctypes.c_int
            self.fn[name] = fn

    def _call(self, name, *args):
        rc = self.fn[name](*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent {name}: CUDA error {rc}")

    def lb_step_tiled(self, dist, force, tau, lat, tile, with_u=True):
        dist2 = torch.empty_like(dist)
        u = torch.empty_like(force) if with_u else None
        soa = (SOA.descriptor(),) * 4 if self.layouts else ()
        self._call("rt_lb_step_tiled", dist.data_ptr(), force.data_ptr(), dist2.data_ptr(),
                   u.data_ptr() if with_u else None, *lat, *tile, *k7.lb_params(float(tau)),
                   *soa, k8.K9_BLOCK)
        return dist2, u

    def wkv(self, r, k, v, w, u, s0, chunk):
        """K10 on fp32 (BH, T, d) tensors, as ``k10.rwkv6_cuda`` launches
        it: -> o (BH, T, dv), sT (BH, dk, dv)."""
        BH, T, dk = r.shape
        dv = v.shape[-1]
        r, k, v, w = (x.float()[:, None].contiguous() for x in (r, k, v, w))
        o = torch.empty((BH, 1, T, dv), device=r.device)
        states = torch.empty((BH, T // chunk, dk, dv), device=r.device)
        sT = torch.empty((BH, 1, dk, dv), device=r.device)
        strides, vstrides = r.stride()[:3], v.stride()[:3]
        self._call("rt_rwkv6_state", k.data_ptr(), v.data_ptr(), w.data_ptr(), s0.data_ptr(),
                   states.data_ptr(), sT.data_ptr(), BH, 1, T, chunk, dk, dv, *strides,
                   *vstrides, 0)
        self._call("rt_rwkv6_output", r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                   u.data_ptr(), states.data_ptr(), o.data_ptr(), BH, 1, T, chunk, dk, dv,
                   *strides, *vstrides, u.stride(0), 0, *o.stride()[:3], 0, 0)
        return o[:, 0], sT[:, 0]


def k9_turns(parent, state, cfg, tile):
    """Q4 (after T1): K9 at T1's lattice and tile, both graphs, u bitwise
    the parent's design and dist2 bitwise the plain LB step and within
    tolerance of the parent's (:func:`_pinned_check`), in turns (a call at
    a time: the wrappers allocate)."""
    lat, tau = cfg.lattice, cfg.tau
    V = math.prod(lat)
    dev = state.dist.data.device
    gen = torch.Generator(device=dev).manual_seed(4)
    dist = state.dist.data * (1.0 + 0.05 * torch.randn((19, V), generator=gen, device=dev))
    force = 1e-3 * torch.randn((3, V), generator=gen, device=dev)
    plain2 = k8.lb_step_plain(dist, force, tau, lat, with_u=False)[0]
    cases = {
        "lb_step_tiled": (lambda: k8.lb_step_tiled_cuda(dist, force, tau, lat, tile),
                          lambda: parent.lb_step_tiled(dist, force, tau, lat, tile), None,
                          176 * V, FLOPS["lb_step"] * V, _pinned_check("K9 lb_step", plain2)),
        "lb_collide_propagate_tiled": (
            lambda: k8.lb_step_tiled_cuda(dist, force, tau, lat, tile, with_u=False)[:1],
            lambda: parent.lb_step_tiled(dist, force, tau, lat, tile, with_u=False)[:1], None,
            164 * V, FLOPS["collide"] * V, _pinned_check("K9 lb_collide_propagate", plain2)),
    }
    log(f"Q4: K9 at {lat}, tile {tile}, in turns with the parent's design:")
    rows = redesign_turns(cases, graphs=False)
    del dist, force, cases, plain2
    torch.cuda.empty_cache()
    return rows


def k10_turns(parent):
    """Q4 (after R1): K10 at R1's two full shapes (fp32 (BH, T, d)) within
    the K10 tolerance of the parent's design, in turns."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    H, d, C = 64, 64, 64
    rows = {}
    for name, (B, T) in (("rwkv6_wkv", (PREFILL_B, PREFILL_T)), ("rwkv6_wkv_long", WKV_LONG)):
        BH = B * H
        args = wkv_problem(gen, BH, T, d, d)

        def check(old, new, shape=(B, H, T, d, d)):
            for o_, n_, what in zip(old, new, ("o", "state")):
                wkv_err(n_, o_, f"K10 {what} at {shape} against the parent's")

        cases = {name: (lambda: k10.rwkv6_cuda(*args, chunk=C),
                        lambda: parent.wkv(*args, C), None, *wkv_work(BH, T, C, d, d), check)}
        log(f"Q4: K10 at (B, H, T, dk, dv) = {(B, H, T, d, d)} in turns with the parent's "
            f"design:")
        rows.update(redesign_turns(cases, graphs=False))
        del args, cases
    torch.cuda.empty_cache()
    return rows


# -- batched solve serving (S1-S3) -------------------------------------------------

def bits_err(got, want, name):
    """Raise unless got and want are bitwise equal, NaN and -0.0 included
    (fp32 or bf16)."""
    word = torch.int16 if got.element_size() == 2 else torch.int32
    if got.dtype != want.dtype or not torch.equal(got.contiguous().view(word),
                                                  want.contiguous().view(word)):
        raise AssertionError(f"{name}: not bitwise equal")
    return 0.0


def tree_err(got, want, name):
    """K2 against core/reduce.py's emulation of its fold tree, run on the
    card (elementwise fp32 adds: the same IEEE arithmetic on either device):
    bitwise."""
    return bits_err(got, want, f"{name} vs its tree emulation")


def batch_inputs(lattice, lay):
    """S1's inputs, SLOTS stacked spinors x, r, p, ap in ``lay`` drawn on the
    card: slot 2 all-zero, slot 3 with -0.0 and a NaN in x and r (the y
    inputs of the masked chains, frozen there); alpha, neg_alpha, m (SLOTS,)
    with m 0 in S1_FROZEN; the batched fold's partial rows."""
    V, dev = math.prod(lattice), torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for n in ("x", "r", "p", "ap"):
        c = torch.randn((SLOTS, 24, V), generator=gen, device=dev)
        c[2] = 0.0
        if n in ("x", "r"):
            c[3, 0, 5], c[3, 9, 2] = -0.0, float("nan")
        out[n] = c if lay == SOA else torch.stack([lay.pack(e) for e in c])
        del c
    alpha = torch.tensor([0.37, -1.5, 0.25, 2.0], device=dev)[:SLOTS]
    m = torch.ones(SLOTS, device=dev)
    m[list(S1_FROZEN)] = 0.0
    out.update(alpha=alpha, neg_alpha=-alpha, m=m,
               partials=torch.randn((SLOTS, -(-V // 128), 24), generator=gen, device=dev))
    return out


def check_batch_layout(u, lattice, lay, vvl, rows):
    """S1 in one layout: every batch kernel per slot bitwise its single
    launch, frozen slots bitwise their y inputs, live slots within tolerance
    of the plain version; timed into ``rows`` when given (SoA)."""
    V = math.prod(lattice)
    inp = batch_inputs(lattice, lay)
    x, r, p, ap, alpha, neg_alpha, m = (inp[n] for n in ("x", "r", "p", "ap", "alpha",
                                                          "neg_alpha", "m"))
    lays = {n: lay for n in ("x", "r", "p", "ap")}
    xy = {"x": lay, "y": lay}
    tag = f"S1 {lay.name}"
    nlive = len(S1_LIVE)

    def row(*a, **kw):
        if rows is not None:
            add_row(rows, *a, **kw)

    def upd():
        return fuse.cg_update_masked(x, r, p, ap, alpha, neg_alpha, m, vvl, layouts=lays)

    got, want = upd(), fuse.cg_update_masked_plain(x, r, p, ap, alpha, neg_alpha, m, lays)
    err = 0.0
    for b in S1_LIVE:
        one = fuse.cg_update(x[b], r[b], p[b], ap[b], alpha[b], neg_alpha[b], vvl, layouts=lays)
        for k, what in enumerate(("x_new", "r_new", "rr")):
            bits_err(got[k][b], one[k], f"{tag} cg_update_masked {what} slot {b} vs cg_update")
        err = max(err, field_err(lay.unpack(got[0][b]), lay.unpack(want[0][b]), "x_new"),
                  field_err(lay.unpack(got[1][b]), lay.unpack(want[1][b]), "r_new"),
                  sum_err(got[2][b], want[2][b], lay.unpack(want[1][b]) ** 2, "rr"))
    for b in S1_FROZEN:
        bits_err(got[0][b], x[b], f"{tag} cg_update_masked frozen x_new slot {b}")
        bits_err(got[1][b], r[b], f"{tag} cg_update_masked frozen r_new slot {b}")
    del got, want
    if rows is not None:
        ms = time_ms(upd)
        row("cg_update_masked", err, ms,
            time_ms(lambda: fuse.cg_update_masked_plain(x, r, p, ap, alpha, neg_alpha, m, lays),
                    reps=3, warm=1),
            (nlive * 6 + (SLOTS - nlive) * 4) * 96 * V,
            (nlive * 6 + (SLOTS - nlive) * 2) * 24 * V)
    else:
        log(f"  {tag} cg_update_masked {time_ms(upd):.4f} ms")

    got = fuse.cg_xpay_masked(p, r, alpha, m, vvl, layouts=xy)
    err = 0.0
    for b in S1_LIVE:
        bits_err(got[b], fuse.cg_xpay(p[b], r[b], alpha[b], vvl, layouts=xy),
                 f"{tag} cg_xpay_masked slot {b} vs cg_xpay")
        err = max(err, field_err(lay.unpack(got[b]),
                                 lay.unpack(r[b]) + alpha[b] * lay.unpack(p[b]), "cg_xpay_masked"))
    for b in S1_FROZEN:
        bits_err(got[b], r[b], f"{tag} cg_xpay_masked frozen slot {b}")
    del got
    if rows is not None:
        row("cg_xpay_masked", err,
            time_ms(lambda: fuse.cg_xpay_masked(p, r, alpha, m, vvl, layouts=xy)),
            time_ms(lambda: fuse.cg_xpay_masked_plain(p, r, alpha, m, xy), reps=3, warm=1),
            (nlive * 3 + (SLOTS - nlive) * 2) * 96 * V, nlive * 2 * 24 * V)

    prod = target.site_mul(x, r, vvl, layouts=xy, batch=SLOTS)
    bits_err(prod, target.mul_plain(x, r, xy, batch=SLOTS), f"{tag} dot_prod vs plain")
    sums = reduce.reduce_sites_batched(prod, "sum", vvl, layouts={"x": lay})
    err = 0.0
    for b in range(SLOTS):
        bits_err(prod[b], target.site_mul(x[b], r[b], vvl, layouts=xy),
                 f"{tag} dot_prod slot {b} vs the single product")
        bits_err(sums[b], reduce.reduce_sites(prod[b], "sum", vvl, layouts={"x": lay}),
                 f"{tag} reduce_sum_batched slot {b} vs reduce_sum")
        if b != 3:  # slot 3 carries the NaN
            c = lay.unpack(prod[b])
            err = max(err, sum_err(sums[b], reduce.reduce_plain(c, "sum"), c,
                                   "reduce_sum_batched"))
    bits_err(reduce.reduce_sites_batched(prod, "max", vvl, layouts={"x": lay})[0],
             reduce.reduce_plain(lay.unpack(prod[0]), "max"), f"{tag} reduce_max_batched")
    tree_err(sums[:3], reduce.reduce_tree(torch.stack([lay.unpack(e) for e in prod[:3]])),
             f"{tag} reduce_sum_batched slots 0-2")   # slot 3 carries the NaN
    if rows is not None:
        row("dot_prod", 0.0,
            time_ms(lambda: target.site_mul(x, r, vvl, layouts=xy, batch=SLOTS)),
            time_ms(lambda: target.mul_plain(x, r, xy, batch=SLOTS)), SLOTS * 3 * 96 * V,
            SLOTS * 24 * V, library_ms=time_ms(lambda: torch.mul(x, r)))
        row("reduce_sum_batched", err,
            time_ms(lambda: reduce.reduce_sites_batched(prod, "sum", vvl, layouts={"x": lay})),
            time_ms(lambda: torch.stack([reduce.reduce_plain(lay.unpack(e), "sum")
                                         for e in prod])),
            SLOTS * 96 * V, SLOTS * 24 * V, library_ms=time_ms(lambda: torch.sum(prod, dim=-1)))
    del prod, sums

    parts = inp["partials"]
    folded = reduce.fold_partials_batched(parts, "sum")
    err = 0.0
    tree_err(folded, reduce.fold_tree(parts), f"{tag} reduce_fold_batched")
    for b in range(SLOTS):
        bits_err(folded[b], reduce.fold_partials(parts[b], "sum"),
                 f"{tag} reduce_fold_batched slot {b} vs reduce_fold")
        err = max(err, sum_err(folded[b], parts[b].sum(dim=0), parts[b].T, "reduce_fold_batched"))
    if rows is not None:
        row("reduce_fold_batched", err,
            time_ms(lambda: reduce.fold_partials_batched(parts, "sum")),
            time_ms(lambda: torch.stack([reduce.reduce_plain(e, "sum", dim=0) for e in parts])),
            parts.numel() * 4 + SLOTS * 96, parts.numel(),
            library_ms=time_ms(lambda: torch.sum(parts, dim=1)))

    ul = u if lay == SOA else u.as_layout(lay)
    wl = {"p": lay, "u": lay}

    def normal():
        return wk.wilson_normal_cuda(p, ul.data, KAPPA, lattice, vvl, layouts=wl, batched=True)

    got = normal()
    want = wk.wilson_normal_plain(p, ul.data, KAPPA, lattice, wl, batched=True)
    err = 0.0
    for b in range(SLOTS):
        one = wk.wilson_normal_cuda(p[b], ul.data, KAPPA, lattice, vvl, layouts=wl)
        bits_err(got[0][b], one[0], f"{tag} wilson_normal_batched ap slot {b} vs wilson_normal")
        bits_err(got[1][b], one[1], f"{tag} wilson_normal_batched pap slot {b} vs wilson_normal")
        pb, wb = lay.unpack(p[b]), lay.unpack(want[0][b])
        err = max(err, field_err(lay.unpack(got[0][b]), wb, "wilson_normal_batched ap"),
                  sum_err(got[1][b], want[1][b], pb * wb, "wilson_normal_batched pap"))
    del got, want, one
    if rows is not None:
        row("wilson_normal_batched", err, time_ms(normal),
            time_ms(lambda: wk.wilson_normal_plain(p, ul.data, KAPPA, lattice, wl, batched=True),
                    reps=3, warm=1),
            (SLOTS * (24 + 24) + 72) * 4 * V, SLOTS * (2 * (1320 + 48) + 48) * V)
    else:
        log(f"  {tag} wilson_normal_batched {time_ms(normal):.4f} ms")
    del inp, x, r, p, ap, parts, ul
    torch.cuda.empty_cache()


def check_batch_kernels(u, lattice, vvl):
    """S1: the batch instances at the full lattice, SoA (timed) and
    S1_LAYOUT."""
    rows = {}
    log(f"S1: batch kernels, {SLOTS} slots at {lattice}, vvl {vvl}, soa:")
    check_batch_layout(u, lattice, SOA, vvl, rows)
    log(f"S1: the same in {S1_LAYOUT}, bitwise per slot and against the plain versions:")
    check_batch_layout(u, lattice, parse_layout(S1_LAYOUT), vvl, None)
    return rows


def spinor(lattice, seed):
    return Field.from_numpy("b", milc_fields.random_spinor(lattice, seed=seed), lattice,
                            device="cuda")


def serve_sources(cfg, u, seed):
    """S2's four sources: random, spectrally filtered (6 applications of the
    normal operator, normalised: it converges earlier), random, all-zero."""
    bs = [spinor(cfg.lattice, seed + 10 + i) for i in range(3)]
    _, _, normal = make_wilson_op(u, cfg.kappa, cfg.target)
    f = bs[1]
    for _ in range(6):
        f = normal(f)
    bs[1] = f.with_data(f.data / torch.linalg.norm(f.data))
    return bs + [bs[0].with_data(torch.zeros_like(bs[0].data))]


def same_outcome(x, iterations, residual, want, name):
    """A served outcome against the dedicated solve's CGResult: x bitwise,
    the same iterations and residual (NaN for an empty source in both)."""
    exact_err(x.data, want.x.data, f"{name}: x against the dedicated solve's")
    if iterations != want.iterations:
        raise AssertionError(f"{name}: {iterations} iterations, the dedicated solve "
                             f"{want.iterations}")
    res, wres = float(residual), float(want.residual)
    if res != wres and not (math.isnan(res) and math.isnan(wres)):
        raise AssertionError(f"{name}: residual {res} != {wres}")


def batched_loop_s(cfg, u, bs, res):
    """Seconds of cg_batched's iteration loop alone on S2's sources: the
    rhs stack and the initial state are built and synchronised first.  The
    loop is cg_batched's; its x and iterations must be bitwise ``res``'s."""
    _, apply_mdag, _ = make_wilson_op(u, cfg.kappa, cfg.target)
    normal = make_fused_normal(u, cfg.kappa, cfg.target)
    rhs = BatchedField.stack([apply_mdag(b) for b in bs], name="rhs")
    state = batched_cg_state(rhs, cfg.target)
    kw = dict(tol=cfg.tol, max_iter=cfg.max_iter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while bool(batched_cg_active(state, **kw).any()):
        state = batched_cg_iteration(state, normal, config=cfg.target, **kw)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    exact_err(state.x.data, res.x.data, "S2: the timed loop's x against solve_batched's")
    if not torch.equal(state.it, res.iterations):
        raise AssertionError(f"S2: the timed loop took {state.it.tolist()} iterations, "
                             f"solve_batched {res.iterations.tolist()}")
    return loop_s


def serve_solve(cfg, u, seed):
    """S2: driver.solve_batched on four sources against the cuda solve of
    each; returns (sources, dedicated results and seconds, counts, ms an
    iteration, seconds)."""
    bs = serve_sources(cfg, u, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = solve_batched(cfg, u, bs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = path_counts(SERVE_PATH)
    single = path_counts(PATH)
    peak = torch.cuda.max_memory_allocated()
    its = res.iterations.tolist()
    loop_s = batched_loop_s(cfg, u, bs, res)
    ms_it = loop_s / max(its) * 1e3
    log(f"S2: solve_batched {cfg.lattice}, {SLOTS} slots: iterations {its}, {dt:.3f} s with "
        f"the rhs and the initial state; the iteration loop alone {loop_s:.3f} s, {ms_it:.3f} "
        f"ms a batched iteration; peak {peak / 2**30:.2f} GiB; launches {counts}, "
        f"single {dict((n, single[n]) for n in SERVE_SINGLE)}")
    idle = [n for n, c in counts.items() if c == 0] + [n for n in SERVE_SINGLE if single[n] == 0]
    if idle:
        raise AssertionError(f"S2: kernels of the batched path never launched: {idle}")
    if not (its[1] < its[0] and its[3] == 0):
        raise AssertionError(f"S2: iterations {its}: the filtered slot must take fewer, the "
                             f"empty one 0")
    if res.x.element(3).data.any():
        raise AssertionError("S2: the empty slot's x is not 0")
    dedicated = []
    for i in range(3):
        one, one_s = solve_timed(cfg, u, bs[i])
        same_outcome(res.x.element(i), its[i], res.residual[i], one, f"S2 slot {i}")
        rc = residual_check(cfg, u, bs[i], res.x.element(i))
        log(f"S2: slot {i}: {its[i]} iterations bitwise the dedicated solve's ({one_s:.3f} s), "
            f"|Mx-b|/|b| = {rc:.3e}")
        if not rc < 1e-3:
            raise AssertionError(f"S2 slot {i}: residual_check {rc} >= 1e-3")
        dedicated.append((one, one_s))
    del res
    torch.cuda.empty_cache()
    return bs, dedicated, counts, ms_it, dt, peak


def serve_drain(cfg, u, su, small, bs, dedicated, seed):
    """S3: a SolveServer drain, DRAIN_REQUESTS at the full lattice in SLOTS
    slots and SMALL_REQUESTS at ``small`` in SMALL_SLOTS, interleaved; every
    outcome bitwise the dedicated solve.  Returns the run's numbers."""
    scfg = dataclasses.replace(cfg, lattice=small)
    full = bs[:3] + [spinor(cfg.lattice, seed + 20 + i) for i in range(DRAIN_REQUESTS - 3)]
    want = {i: dedicated[i] for i in range(3)}
    for i in range(3, DRAIN_REQUESTS):
        want[i] = solve_timed(cfg, u, full[i])
    smalls = [spinor(small, seed + 30 + i) for i in range(SMALL_REQUESTS)]
    for i, b in enumerate(smalls):
        want[100 + i] = solve_timed(scfg, su, b)
    server = SolveServer(cfg.target, slots=SLOTS, tol=cfg.tol, max_iter=cfg.max_iter)
    server.register(u, cfg.kappa)
    server.register(su, cfg.kappa, slots=SMALL_SLOTS)
    reqs = [SolveRequest(i, b) for i, b in enumerate(full)]
    sreqs = [SolveRequest(100 + i, b) for i, b in enumerate(smalls)]
    for k in range(max(len(reqs), len(sreqs))):   # the shapes interleaved
        for q in (reqs, sreqs):
            if k < len(q):
                server.submit(q[k])
    ticks = []
    for bucket in server.buckets.values():
        def timed(bucket=bucket, tick=bucket.tick):
            occ = bucket.occupied + min(bucket.slots - bucket.occupied, len(bucket.queue))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tick()
            torch.cuda.synchronize()
            ticks.append((bucket.u.lattice, occ, time.perf_counter() - t0))
            return out
        bucket.tick = timed
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = server.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {**path_counts(SERVE_PATH), **path_counts(PATH)}
    if sorted(results) != sorted(want):
        raise AssertionError(f"S3: served {sorted(results)}, submitted {sorted(want)}")
    for rid, out in results.items():
        same_outcome(out.x, out.iterations, out.residual, want[rid][0], f"S3 request {rid}")
    idle = [n for n in ("wilson_normal_batched", "cg_update_masked", "cg_xpay_masked",
                        "reduce_fold_batched") + DRAIN_SINGLE if counts[n] == 0]
    if idle:
        raise AssertionError(f"S3: kernels of the drain never launched: {idle}")
    by_occ = {}
    for lat, occ, sec in ticks:
        by_occ.setdefault((lat, occ), []).append(sec * 1e3)
    dedicated_s = sum(w[1] for w in want.values())
    summary = {
        "ticks": {str(lat): b.iterations_run for lat, b in server.buckets.items()},
        "ms_per_tick": {f"{lat}@{occ}": statistics.median(v)
                        for (lat, occ), v in sorted(by_occ.items())},
        "tick_counts": {f"{lat}@{occ}": len(v) for (lat, occ), v in sorted(by_occ.items())},
        "drain_s": dt, "solves_per_s": len(results) / dt, "dedicated_s": dedicated_s,
        "dedicated_solves_per_s": len(results) / dedicated_s,
        "iterations": {rid: out.iterations for rid, out in sorted(results.items())}}
    log(f"S3: {len(results)} requests drained in {dt:.3f} s ({len(results) / dt:.3f} solves/s; "
        f"the dedicated solves one by one {dedicated_s:.3f} s); ticks {summary['ticks']}; "
        f"ms a tick by (lattice, occupancy) {summary['ms_per_tick']} "
        f"(ticks {summary['tick_counts']}); iterations {summary['iterations']}; "
        f"every outcome bitwise its dedicated solve; launches {counts}")
    return summary



# -- mixed precision (P1-P4) ---------------------------------------------------------

def bf16_err(got, want, name):
    """max |got - want| of two bf16 (or fp32) fields, raising unless each
    value lies within one bf16 ulp of the larger magnitude plus the fp32
    field tolerance FIELD_RTOL x max|want|: two fp32 results that differ in
    their last bits round to neighbouring bf16 values, and where
    cancellation leaves a value far below its terms the fp32 difference
    itself is the larger."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    lim = torch.exp2(torch.floor(torch.log2(mag)) - 7) + FIELD_RTOL * w.abs().max()
    ratio = ((g - w).abs() / lim).max().item()
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: {ratio} x (one bf16 ulp + the fp32 tolerance) apart")
    return (g - w).abs().max().item()


def oracle_err(got, terms, name):
    """A compensated sum ``got`` (ncomp,) against the fp64 sum of ``terms``
    (ncomp, sites): within ORACLE_RTOL x sum|terms| + 1e-6 a component."""
    oracle = torch.sum(terms, dim=-1, dtype=torch.float64)
    mass = torch.sum(terms.abs(), dim=-1, dtype=torch.float64)
    err = (got.double() - oracle).abs()
    if not bool((err <= ORACLE_RTOL * mass + 1e-6).all()):
        raise AssertionError(f"{name}: err {err.max().item()} beyond the oracle bound")
    return err.max().item()


def beyond_oracle(got, terms, name):
    """The control of a compensated check: ``got`` (a plain fold) must fall
    outside the oracle bound of ``terms``, so that the bound can tell the
    compensated fold from it.  Returns the worst ratio err / bound."""
    oracle = torch.sum(terms, dim=-1, dtype=torch.float64)
    bound = ORACLE_RTOL * torch.sum(terms.abs(), dim=-1, dtype=torch.float64) + 1e-6
    ratio = ((got.double() - oracle).abs() / bound).min().item()
    if not ratio > 1.0:
        raise AssertionError(f"{name}: the control is within the oracle bound ({ratio} x)")
    return ratio


def check_mixed_milc(u, b, lattice, vvl):
    """P1 at the MILC lattice: A (K5/K5B's policy instance), C (K3/K3B fed a
    bf16 ap) and D (K2's compensated instance) against their plain versions
    in P1_LAYOUTS; timed in SoA beside the policy-free kernels.  Returns
    (rows, the bytes of the reference's model and the policy-free ms)."""
    V = math.prod(lattice)
    inp = milc_inputs(u, b, vvl)
    psi, uu, y, p, ap, alpha, neg_alpha = (
        inp[n] for n in ("psi", "u", "y", "p", "ap", "alpha", "neg_alpha"))
    pol, f32 = CudaPolicy(True, True), CudaPolicy(False, True)
    rows, extra = {}, {}

    def row(name, *a, model_bytes=None, free_ms=None, **kw):
        add_row(rows, name, *a, **kw)
        extra[name] = dict(model_bytes=model_bytes, model_bound_ms=None if model_bytes is None
                           else model_bytes / HBM_BYTES_PER_S * 1e3, policy_free_ms=free_ms)
        log(f"    {name}: policy-free {free_ms} ms"
            + (f", the reference's model {model_bytes / V:.0f} B a site"
               if model_bytes is not None else ""))

    special = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -0.0, float("inf"), -float("inf"),
                            float("nan"), 1e-40, -1e-39, 3.4e38, 1.5 * 2 ** -133], device=uu.device)
    for what, t in (("u", uu), ("special values", special)):
        bits_err(wk.bf16_round_cuda(t), t.to(torch.bfloat16).float(),
                 f"P1 the stage-in rounding of {what}")
    # K5's policy instance itself: at kappa 0, ap = g5 g5 of p as loaded,
    # so its bf16 ap is p's stage-in rounding, bitwise (ties and subnormals
    # placed in p; -0.0, inf and NaN would meet 0 * D p)
    # the operator's bf16 copy of u, which the policy instance reads
    u16 = wk.bf16_pack_cuda(uu)
    err = bits_err(u16, uu.to(torch.bfloat16), "P1 bf16_pack of u vs torch's .to(bfloat16)")
    pt = psi.clone()
    odd = special[torch.tensor([0, 1, 6, 7, 9], device=psi.device)]
    pt[:, :5], pt[:, 5:10] = odd, -odd
    ap_k0, _ = wk.wilson_normal_cuda(pt, u16, 0.0, lattice, vvl, policy=pol)
    bits_err(ap_k0.float(), pt.to(torch.bfloat16).float(),
             "P1 wilson_normal policy at kappa 0: ap vs p's bf16 rounding")
    del pt, ap_k0
    to16_ms = time_ms(lambda: uu.to(torch.bfloat16))
    row("bf16_pack", err, time_ms(lambda: wk.bf16_pack_cuda(uu)), to16_ms, 72 * (4 + 2) * V, 0,
        library_ms=to16_ms)
    rows["bf16_pack_serving"], extra["bf16_pack_serving"] = rows["bf16_pack"], extra["bf16_pack"]
    log("  the stage-in rounding bitwise torch's .to(bfloat16): the helper kernel of "
        "bf16.cuh on u and on ties, -0.0, inf, NaN, subnormals; bf16_pack's copy of u; K5's "
        "policy instance's own load of p (kappa 0, ties and subnormals in p)")
    for spec in P1_LAYOUTS:
        lay = parse_layout(spec)
        lays = {"p": lay, "u": lay, "ap": lay}
        pp, up = (t if lay == SOA else lay.pack(t) for t in (psi, uu))
        ap0, _ = wk.wilson_normal_cuda(pp, up, KAPPA, lattice, vvl, layouts=lays)
        a32, s32 = wk.wilson_normal_cuda(pp, up, KAPPA, lattice, vvl, layouts=lays, policy=f32)
        bits_err(a32, ap0, f"P1 {spec} wilson_normal under fp32 storage vs the policy-free ap")
        oracle_err(s32, psi * lay.unpack(ap0), f"P1 {spec} wilson_normal fp32-storage pap")
        del a32
        up16 = wk.bf16_pack_cuda(up)
        got = wk.wilson_normal_cuda(pp, up16, KAPPA, lattice, vvl, layouts=lays, policy=pol)
        want = wk.wilson_normal_plain(pp, up, KAPPA, lattice, lays, policy=pol)
        err = bf16_err(lay.unpack(got[0]), lay.unpack(want[0]), f"P1 {spec} policy ap")
        ap32, _ = wk.wilson_normal_plain(wk.bf16_round(pp), wk.bf16_round(up), KAPPA, lattice,
                                         lays)
        terms = wk.bf16_round(psi) * lay.unpack(ap32)
        err = max(err, oracle_err(got[1], terms, f"P1 {spec} policy pap"))
        oracle_err(want[1], terms, f"P1 {spec} plain policy pap")
        again = wk.wilson_normal_cuda(pp, up16, KAPPA, lattice, vvl, layouts=lays, policy=pol)
        bits_err(again[0].float(), got[0].float(), f"P1 {spec} policy ap run to run")
        bits_err(again[1], got[1], f"P1 {spec} policy pap run to run")
        del ap32, terms, want, again
        pb = torch.stack([pp, y if lay == SOA else lay.pack(y)])
        bat = wk.wilson_normal_cuda(pb, up16, KAPPA, lattice, vvl, layouts=lays, batched=True,
                                    policy=pol)
        bits_err(bat[0][0].float(), got[0].float(), f"P1 {spec} K5B policy slot 0 vs K5")
        bits_err(bat[1][0], got[1], f"P1 {spec} K5B policy pap slot 0 vs K5")
        one = wk.wilson_normal_cuda(pb[1], up16, KAPPA, lattice, vvl, layouts=lays, policy=pol)
        bits_err(bat[0][1].float(), one[0].float(), f"P1 {spec} K5B policy slot 1 vs K5")
        bits_err(bat[1][1], one[1], f"P1 {spec} K5B policy pap slot 1 vs K5")
        del bat, one, pb, up16
        # C: K3 fed a bf16 ap, bitwise K3 on the widened ap
        cl = {n: lay for n in ("x", "r", "p", "ap")}
        xs, rs, ps = (t if lay == SOA else lay.pack(t) for t in (psi, y, p))
        ap16 = (ap if lay == SOA else lay.pack(ap)).to(torch.bfloat16)
        c16 = fuse.cg_update(xs, rs, ps, ap16, alpha, neg_alpha, vvl, layouts=cl)
        cwide = fuse.cg_update(xs, rs, ps, ap16.float(), alpha, neg_alpha, vvl, layouts=cl)
        for k in range(3):
            bits_err(c16[k], cwide[k], f"P1 {spec} cg_update_ap16 vs cg_update on the widened ap")
        cw = fuse.cg_update_plain(xs, rs, ps, ap16, alpha, neg_alpha, cl)
        cerr = max(field_err(lay.unpack(c16[1]), lay.unpack(cw[1]), "cg_update_ap16 r_new"),
                   sum_err(c16[2], cw[2], lay.unpack(cw[1]) ** 2, "cg_update_ap16 rr"))
        del cwide, cw
        # D: the compensated sum of the product field and of the fixture
        prod = psi * y
        pl = prod if lay == SOA else lay.pack(prod)
        got_c = reduce.reduce_sites(pl, "sum", vvl, layouts={"x": lay}, compensated=True)
        oracle_err(got_c, prod, f"P1 {spec} reduce_sum_comp")
        tree_err(got_c, reduce.reduce_tree(prod, compensated=True), f"P1 {spec} reduce_sum_comp")
        del got_c
        log(f"  {spec}: wilson_normal policy (bf16, compensated) ap within one bf16 ulp, "
            f"pap within the oracle bound, K5B slots bitwise; fp32 storage bitwise "
            f"the policy-free ap; cg_update_ap16 bitwise on the widened ap; the "
            f"compensated sum within the oracle bound")
        if lay != SOA:
            del got, c16, prod, pl, xs, rs, ps, ap16, pp, up
            torch.cuda.empty_cache()
            continue
        fix = reduce.cancel_field(24, V, psi.device)
        comp_err = oracle_err(reduce.reduce_sites(fix, "sum", vvl, compensated=True), fix,
                              "P1 the cancellation fixture, compensated")
        plain_ratio = beyond_oracle(reduce.reduce_sites(fix, "sum", vvl), fix,
                                    "P1 the cancellation fixture, the plain K2")
        log(f"  the cancellation fixture at V = {V}: compensated err {comp_err:.3e}, within "
            f"the oracle bound; the plain K2 {plain_ratio:.3f} x the bound, outside it")
        del fix
        # timed as the main path runs it: on the operator's bf16 copy of u
        free = time_ms(lambda: wk.wilson_normal_cuda(psi, uu, KAPPA, lattice, vvl))
        row("wilson_normal_policy", err,
            time_ms(lambda: wk.wilson_normal_cuda(psi, u16, KAPPA, lattice, vvl, policy=pol)),
            time_ms(lambda: wk.wilson_normal_plain(psi, uu, KAPPA, lattice, policy=pol),
                    reps=3, warm=1),
            (24 + 36 + 12) * 4 * V, (2 * (1320 + 48) + 48) * V, model_bytes=240 * V,
            free_ms=free)
        pb = torch.stack([psi] * SLOTS)
        row("wilson_normal_batched_policy", err,
            time_ms(lambda: wk.wilson_normal_cuda(pb, u16, KAPPA, lattice, vvl, batched=True,
                                                  policy=pol)),
            time_ms(lambda: wk.wilson_normal_plain(pb, uu, KAPPA, lattice, batched=True,
                                                   policy=pol), reps=1, warm=0),
            (SLOTS * (24 + 12) + 36) * 4 * V, SLOTS * (2 * (1320 + 48) + 48) * V,
            model_bytes=(SLOTS * (12 + 12) + 36) * 4 * V,
            free_ms=time_ms(lambda: wk.wilson_normal_cuda(pb, uu, KAPPA, lattice, vvl,
                                                          batched=True)))
        del pb
        ap16 = ap.to(torch.bfloat16)
        row("cg_update_ap16", cerr,
            time_ms(lambda: fuse.cg_update(psi, y, p, ap16, alpha, neg_alpha, vvl)),
            time_ms(lambda: fuse.cg_update_plain(psi, y, p, ap16, alpha, neg_alpha)),
            (5 * 24 + 12) * 4 * V, 24 * 6 * V, model_bytes=(5 * 24 + 12) * 4 * V,
            free_ms=time_ms(lambda: fuse.cg_update(psi, y, p, ap, alpha, neg_alpha, vvl)))
        st = [torch.stack([t] * SLOTS) for t in (psi, y, p)]
        ap16b, apb = torch.stack([ap16] * SLOTS), torch.stack([ap] * SLOTS)
        a_b, m_b = alpha.repeat(SLOTS), torch.ones(SLOTS, device=psi.device)
        got_b = fuse.cg_update_masked(*st, ap16b, a_b, -a_b, m_b, vvl)
        for k in range(3):
            bits_err(got_b[k][1], c16[k], f"P1 cg_update_masked_ap16 slot 1 vs cg_update_ap16")
        del got_b
        row("cg_update_masked_ap16", cerr,
            time_ms(lambda: fuse.cg_update_masked(*st, ap16b, a_b, -a_b, m_b, vvl)),
            time_ms(lambda: fuse.cg_update_masked_plain(*st, ap16b, a_b, -a_b, m_b),
                    reps=3, warm=1),
            SLOTS * (5 * 24 + 12) * 4 * V, SLOTS * 24 * 6 * V,
            model_bytes=SLOTS * (5 * 24 + 12) * 4 * V,
            free_ms=time_ms(lambda: fuse.cg_update_masked(*st, apb, a_b, -a_b, m_b, vvl)))
        del st, ap16b, apb
        nb = -(-V // vvl)
        pairs = reduce.fold_pairs(nb, 24, psi.device)
        hi = pairs[..., 0].contiguous()   # the policy-free fold's rows
        pair_terms = pairs.permute(1, 0, 2).reshape(24, -1)
        ferr = oracle_err(reduce.fold_partials(pairs, "sum", compensated=True), pair_terms,
                          "P1 reduce_fold_comp")
        tree_err(reduce.fold_partials(pairs, "sum", compensated=True),
                 reduce.fold_tree(pairs, compensated=True), "P1 reduce_fold_comp")
        lo_ratio = beyond_oracle(reduce.fold_partials(hi, "sum"), pair_terms,
                                 "P1 the fold of the his alone (lo dropped)")
        log(f"  reduce_fold_comp on pairs whose lo carries the sum: err {ferr:.3e}; the "
            f"plain fold of the his alone {lo_ratio:.3e} x the oracle bound")
        row("reduce_fold_comp", ferr,
            time_ms(lambda: reduce.fold_partials(pairs, "sum", compensated=True)),
            time_ms(lambda: reduce.compensated_plain(pairs.permute(1, 0, 2).reshape(24, -1))),
            pairs.numel() * 4 + 96, pairs.numel(), model_bytes=None,
            free_ms=time_ms(lambda: reduce.fold_partials(hi, "sum")),
            library_ms=time_ms(lambda: torch.sum(pairs, dim=(0, 2), dtype=torch.float64)))
        pairs_b = torch.stack([pairs] * SLOTS)
        hi_b = pairs_b[..., 0].contiguous()
        folded = reduce.fold_partials_batched(pairs_b, "sum", compensated=True)
        bits_err(folded[2], reduce.fold_partials(pairs, "sum", compensated=True),
                 "P1 reduce_fold_comp_batched slot 2 vs the single fold")
        row("reduce_fold_comp_batched", ferr,
            time_ms(lambda: reduce.fold_partials_batched(pairs_b, "sum", compensated=True)),
            time_ms(lambda: torch.stack([reduce.compensated_plain(
                e.permute(1, 0, 2).reshape(24, -1)) for e in pairs_b])),
            pairs_b.numel() * 4 + SLOTS * 96, pairs_b.numel(), model_bytes=None,
            free_ms=time_ms(lambda: reduce.fold_partials_batched(hi_b, "sum")),
            library_ms=time_ms(lambda: torch.sum(pairs_b, dim=(1, 3), dtype=torch.float64)))
        del got, c16, prod, pl, xs, rs, ps, ap16, pp, up, pairs, pairs_b, folded, hi, hi_b
        del pair_terms
        torch.cuda.empty_cache()
    del inp, psi, uu, y, p, ap
    torch.cuda.empty_cache()
    return rows, extra


def check_mixed_ludwig(state, cfg, vvl):
    """P1 at the Ludwig lattice: B (K5L's policy instance) and D (K2's
    compensated sum of dist) against their plain versions in P1_LAYOUTS, the
    LB graph under fp32 storage bitwise the policy-free one; timed in SoA."""
    lat, V = cfg.lattice, math.prod(cfg.lattice)
    inp = ludwig_inputs(state, vvl)
    dist, force, tau = inp["dist"], inp["force"], cfg.tau
    dist_tree = reduce.reduce_tree(dist, compensated=True)
    rows, extra = {}, {}
    for spec in P1_LAYOUTS:
        lay = parse_layout(spec)
        lays = {"dist": lay, "force": lay, "dist2": lay, "u": lay}
        d, f = (t if lay == SOA else lay.pack(t) for t in (dist, force))
        got = k8.lb_step_cuda(d, f, tau, lat, vvl, layouts=lays, bf16=True)
        want = k8.lb_step_plain(d, f, tau, lat, layouts=lays, bf16=True)
        err = max(bf16_err(lay.unpack(got[0]), lay.unpack(want[0]), f"P1 {spec} dist2"),
                  bf16_err(lay.unpack(got[1]), lay.unpack(want[1]), f"P1 {spec} u"))
        del want
        fd, ff = Field("dist", 19, lat, lay, d), Field("force", 3, lat, lay, f)
        g = ludwig.lb_step_graph(cfg)
        free = g.launch({"dist": fd, "force": ff}, config=cfg.target, outputs=("dist2", "u"))
        f32 = g.launch({"dist": fd, "force": ff}, config=dataclasses.replace(cfg.target, dtypes=F32),
                       outputs=("dist2", "u"))
        for o in ("dist2", "u"):
            bits_err(f32[o].data, free[o].data, f"P1 {spec} lb step {o} under fp32 storage")
        del free, f32
        got_c = reduce.reduce_sites(d, "sum", vvl, layouts={"x": lay}, compensated=True)
        derr = oracle_err(got_c, dist, f"P1 {spec} the compensated sum of dist")
        tree_err(got_c, dist_tree, f"P1 {spec} the compensated sum of dist")
        log(f"  {spec}: lb_step policy (bf16) dist2 and u within one bf16 ulp, fp32 storage "
            f"bitwise the policy-free step, the compensated sum of dist within the oracle bound")
        if lay == SOA:
            def add(name, err, ms, plain_ms, nbytes, flops, model_bytes, free_ms, **kw):
                add_row(rows, name, err, ms, plain_ms, nbytes, flops, **kw)
                extra[name] = dict(model_bytes=model_bytes, model_bound_ms=None
                                   if model_bytes is None else model_bytes / HBM_BYTES_PER_S * 1e3,
                                   policy_free_ms=free_ms)
                log(f"    {name}: policy-free {free_ms} ms")

            add("lb_step_bf16", err,
                time_ms(lambda: k8.lb_step_cuda(d, f, tau, lat, vvl, bf16=True)),
                time_ms(lambda: k8.lb_step_plain(d, f, tau, lat, bf16=True), reps=3, warm=1),
                (22 * 4 + 22 * 2) * V, FLOPS["lb_step"] * V, 22 * 2 * 2 * V,
                time_ms(lambda: k8.lb_step_cuda(d, f, tau, lat, vvl)))
            add("reduce_sum_comp", derr,
                time_ms(lambda: reduce.reduce_sites(d, "sum", vvl, compensated=True)),
                time_ms(lambda: reduce.compensated_plain(d)), 76 * V, 19 * V, None,
                time_ms(lambda: reduce.reduce_sites(d, "sum", vvl)),
                library_ms=time_ms(lambda: torch.sum(d, dim=1, dtype=torch.float64)))
        del got, d, f, fd, ff
        torch.cuda.empty_cache()
    del inp, dist, force
    torch.cuda.empty_cache()
    return rows, extra


def mixed_solve(cfg, u, b, x_full, iterations, full_s):
    """P2: the refined solve (storage bfloat16) on phase 2's u and b, with
    every count set to 0: |Mx - b|/|b| < 1e-3, x within MIXED_REL_X of
    phase 4's x, every kernel of MIXED_PATH and the policy-free
    wilson_normal (the restarts' true residual) launched.  Returns
    (summary, counts, x on the host), x for T5's budgeted refined solve."""
    mcfg = dataclasses.replace(cfg, storage="bfloat16")
    reset_counts()
    res, dt = solve_timed(mcfg, u, b)
    counts = path_counts(MIXED_PATH)
    restarts = wk.WILSON_NORMAL_AP.launches
    counts["wilson_normal"] = path_counts(PATH)["wilson_normal"]
    rc = residual_check(cfg, u, b, res.x)
    rel = (torch.linalg.norm(res.x.data - x_full) / torch.linalg.norm(x_full)).item()
    log(f"P2: refined solve {cfg.lattice} (bf16 storage): {res.iterations} inner iterations "
        f"(phase 4: {iterations}), {restarts} restarts, {dt:.3f} s to solution (phase 4: "
        f"{full_s:.3f} s), {dt / max(res.iterations, 1) * 1e3:.3f} ms an inner iteration "
        f"with the restarts; |Mx-b|/|b| = {rc:.3e}, x rel-L2 {rel:.3e} from phase 4's; "
        f"launches {counts}")
    if not torch.isfinite(res.x.data).all():
        raise AssertionError("P2: non-finite x")
    if not (rc < 1e-3 and rel < MIXED_REL_X):
        raise AssertionError(f"P2: residual_check {rc}, x rel {rel}")
    idle = [n for n, c in counts.items() if c == 0]
    if idle:
        raise AssertionError(f"P2: kernels of the refined path never launched: {idle}")
    summary = dict(iterations=res.iterations, restarts=restarts, s=dt, full_iterations=iterations,
                   full_s=full_s, residual_check=rc, x_rel=rel)
    x = res.x.data.cpu()
    del res
    torch.cuda.empty_cache()
    return summary, counts, x


def mixed_serving(su, small, seed):
    """P3 at ``small`` on phase 5's u: solve_batched (SLOTS sources) and a
    SolveServer drain (P3_SERVER_SLOTS slots, the same sources) with the bf16
    policy and restarts every P3_REFINE iterations.  Each outcome: P2's
    checks against the full-precision cuda solve of its source, and bitwise
    the one-slot solve_batched run of it."""
    base = MilcConfig(lattice=small, kappa=KAPPA, tol=TOL, hot=HOT, max_iter=MAX_ITER,
                      target=TargetConfig("cuda", device="cuda"))
    cfg = dataclasses.replace(base, storage="bfloat16", refine_k=P3_REFINE)
    bs = [spinor(small, seed + 40 + i) for i in range(SLOTS)]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_batched(cfg, su, bs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = path_counts(MIXED_SERVE_PATH)
    idle = [n for n, c in counts.items() if c == 0]
    if idle:
        raise AssertionError(f"P3: kernels of refined serving never launched: {idle}")
    server = SolveServer(TargetConfig("cuda", device="cuda", dtypes=BF16),
                         slots=P3_SERVER_SLOTS, tol=TOL, max_iter=MAX_ITER,
                         refine_every=P3_REFINE)
    server.register(su, KAPPA)
    for i, bb in enumerate(bs):
        server.submit(SolveRequest(i, bb))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = server.run()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    its = res.iterations.tolist()
    worst = [0.0, 0.0]
    for i, bb in enumerate(bs):
        one = solve_batched(cfg, su, [bb])
        exact_err(res.x.element(i).data, one.x.element(0).data,
                  f"P3 slot {i}: solve_batched vs its one-slot run")
        exact_err(served[i].x.data, one.x.element(0).data,
                  f"P3 request {i}: the server vs the one-slot run")
        if its[i] != int(one.iterations[0]) or served[i].iterations != its[i]:
            raise AssertionError(f"P3 slot {i}: iterations {its[i]}, served "
                                 f"{served[i].iterations}, one-slot {int(one.iterations[0])}")
        full = solve(base, su, bb)
        rc = residual_check(base, su, bb, res.x.element(i))
        rel = (torch.linalg.norm(res.x.element(i).data - full.x.data)
               / torch.linalg.norm(full.x.data)).item()
        if not (rc < 1e-3 and rel < MIXED_REL_X):
            raise AssertionError(f"P3 slot {i}: residual_check {rc}, x rel {rel}")
        worst = [max(worst[0], rc), max(worst[1], rel)]
    log(f"P3: refined serving {small}, {SLOTS} sources, restarts every {P3_REFINE}: "
        f"solve_batched {dt:.3f} s, iterations {its}; a {P3_SERVER_SLOTS}-slot drain "
        f"{drain_s:.3f} s ({server.buckets[small].iterations_run} ticks); every outcome "
        f"bitwise its one-slot run; worst |Mx-b|/|b| {worst[0]:.3e}, x rel-L2 {worst[1]:.3e} "
        f"from full precision; launches {counts}")
    return dict(iterations=its, solve_batched_s=dt, drain_s=drain_s,
                worst_residual_check=worst[0], worst_x_rel=worst[1]), counts


def ludwig_steps(state, cfg, n):
    """n steps from ``state``; returns the states after 3 and after n."""
    s, third = state, None
    for k in range(n):
        s = step(s, cfg)
        if k == 2:
            third = s
    return third, s


def rel_l2(a, b):
    return (torch.linalg.norm(a.float() - b.float()) / torch.linalg.norm(b.float())).item()


def mixed_ludwig(state, after_steps, cfg, l3_ms, small):
    """P4, with every count set to 0: LUDWIG_STEPS steps from the L1 state
    with storage bfloat16: finite, dist within P4_REL of L3's steps, q
    within P4_REL at step 3 and reported at step 10 (see P4_REL); the mass
    before and after, summed in a counted window of its own (MIXED_SUM_PATH);
    the same steps with storage
    float32 bitwise L3's; at ``small`` the cuda engine's bf16 steps within
    P4_ENGINE_REL of the torch engine's on the card."""
    bcfg = dataclasses.replace(cfg, storage="bfloat16")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    third, s = ludwig_steps(state, bcfg, LUDWIG_STEPS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / LUDWIG_STEPS * 1e3
    counts = path_counts(MIXED_LUDWIG_PATH)
    # the mass diagnostic, a window of its own: a standalone target_sum under
    # an accumulate-only policy (K2's compensated pass 1 and fold), which no
    # driver path runs
    acc = dataclasses.replace(cfg.target, dtypes=DtypePolicy(accumulate="float64"))
    reset_counts()
    m0 = float(reduce.target_sum(state.dist, acc).double().sum())
    m1 = float(reduce.target_sum(s.dist, acc).double().sum())
    sum_counts = path_counts(MIXED_SUM_PATH)
    for name in ("dist", "q"):
        if not torch.isfinite(getattr(s, name).data).all():
            raise AssertionError(f"P4: bf16 {name} has non-finite values")
    rels = {n: rel_l2(getattr(s, n).data, getattr(after_steps, n).data) for n in ("dist", "q")}
    del s
    full3 = ludwig_steps(state, cfg, 3)[0]
    rels["q@3"] = rel_l2(third.q.data, full3.q.data)
    rels["dist@3"] = rel_l2(third.dist.data, full3.dist.data)
    del third, full3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, s = ludwig_steps(state, dataclasses.replace(cfg, storage="float32"), LUDWIG_STEPS)
    torch.cuda.synchronize()
    f32_ms = (time.perf_counter() - t0) / LUDWIG_STEPS * 1e3
    for name in ("dist", "q"):
        exact_err(getattr(s, name).data, getattr(after_steps, name).data,
                  f"P4: fp32 storage {name} vs L3")
    del s
    engines = [LudwigConfig(lattice=small, storage="bfloat16",
                            target=TargetConfig(e, device="cuda")) for e in ("cuda", "torch")]
    (_, sc), (_, st) = (ludwig_steps(init_state(c, seed=0), c, LUDWIG_STEPS) for c in engines)
    erels = {n: rel_l2(getattr(sc, n).data, getattr(st, n).data) for n in ("dist", "q")}
    log(f"P4: ludwig {cfg.lattice} with bf16 LB storage: {ms:.3f} ms/step (fp32 storage, the "
        f"policy-free kernels, in this phase: {f32_ms:.3f}; L3: {l3_ms:.3f}); "
        f"rel-L2 from the fp32 steps: dist {rels['dist@3']:.3e} / {rels['dist']:.3e}, q "
        f"{rels['q@3']:.3e} / {rels['q']:.3e} after 3 / {LUDWIG_STEPS} steps; mass "
        f"(compensated) {m0!r} -> {m1!r} (drift {abs(m1 - m0) / m0:.3e}); fp32 storage "
        f"bitwise L3; at {small} the cuda engine's bf16 steps from the torch engine's: "
        f"dist {erels['dist']:.3e}, q {erels['q']:.3e}; launches {counts}; the mass "
        f"diagnostic's own window (target_sum under an accumulate policy) {sum_counts}")
    if not (rels["dist"] < P4_REL and rels["q@3"] < P4_REL):
        raise AssertionError(f"P4: bf16 steps {rels} from the fp32 steps")
    if not (erels["dist"] < P4_ENGINE_REL and erels["q"] < P4_ENGINE_REL):
        raise AssertionError(f"P4: the cuda engine's bf16 steps {erels} from the torch engine's")
    idle = [n for n, c in {**counts, **sum_counts}.items() if c == 0]
    if idle:
        raise AssertionError(f"P4: kernels of the bf16 step or the mass sum never launched: "
                             f"{idle}")
    return dict(ms_per_step=ms, fp32_ms_per_step=f32_ms, l3_ms_per_step=l3_ms, rel=rels,
                engine_rel=erels, mass=[m0, m1]), counts, sum_counts


# -- the block view (V1) and split reductions (RS1) ----------------------------------

def halo_inner(lattice, ring):
    """The site count of one x-plane of a lattice halo'd by ``ring``."""
    return math.prod(s + 2 * ring for s in lattice[1:])


def check_block_view(graph, outputs, lattice, lay):
    """block_view_ok for ``graph``'s external inputs at the rings its width
    analysis gives them, every input and output in ``lay``."""
    rings = graph.halo_widths(outputs)
    views = [(lay, halo_inner(lattice, r)) for r in rings.values()]
    ok = block_view_ok(views, [lay] * len(outputs), math.prod(lattice[1:]))
    log(f"V1: block_view_ok({lay.name}, rings {rings}, halo'd inner planes "
        f"{[v for _, v in views]}) = {ok}")
    if not ok:
        raise AssertionError(f"V1: {lay.name} is not block-aligned for {graph.name}")


def view_block_milc(cfg, u, b, x_soa, iterations):
    """V1's MILC half: the solve in V1_MILC_LAYOUT under the block plan,
    bitwise phase 4's (and so Y2's in that layout), then one iteration's
    launches under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    lay = parse_layout(V1_MILC_LAYOUT)
    normal = cg_mod.wilson_normal_graph(cfg.kappa)
    check_block_view(normal, ("ap", "pap"), cfg.lattice, lay)
    block = LoweringPlan("cuda", vvl=cfg.target.vvl, bx=1, view="block")
    vcfg = dataclasses.replace(cfg, layout=lay,
                               target=dataclasses.replace(cfg.target, plan_policy=block))
    ul, bl = u.as_layout(lay), b.as_layout(lay)
    reset_counts()
    res, solve_s = solve_timed(vcfg, ul, bl)
    counts = path_counts(PATH)
    rc = residual_check(vcfg, ul, bl, res.x)
    ms_it = solve_s / max(res.iterations, 1) * 1e3
    log(f"V1: solve {cfg.lattice} in {lay.name} under {block.describe()}: {res.iterations} "
        f"iterations, {ms_it:.3f} ms/iter, |Mx-b|/|b| = {rc:.3e}; launches {counts}")
    if res.iterations != iterations:
        raise AssertionError(f"V1: {res.iterations} iterations, phase 4 took {iterations}")
    exact_err(res.x.canonical(), x_soa, "V1: x against phase 4's (Y2's)")
    if not rc < 1e-3:
        raise AssertionError(f"V1: residual_check {rc} >= 1e-3")
    idle = [n for n, c in counts.items() if c == 0]
    if idle:
        raise AssertionError(f"V1: kernels of the path never launched: {idle}")
    # one CG iteration's launches under the block plan: the hand kernels alone
    alpha = torch.tensor(0.37, device=bl.device)
    neg = -alpha
    upd, xpay = cg_mod.cg_update_graph(24), cg_mod.cg_xpay_graph(24)
    hand = ("wilson_normal", "cg_update", "cg_xpay", "reduce_fold")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o = normal.launch({"p": bl, "u": ul}, config=vcfg.target, outputs=("ap", "pap"))
        n = upd.launch({"x": res.x, "r": bl, "p": bl, "ap": o["ap"]},
                       scalars={"alpha": alpha, "neg_alpha": neg}, config=vcfg.target,
                       outputs=("x_new", "r_new", "rr"))
        xpay.launch({"x": bl, "y": n["r_new"]}, scalars={"a": alpha}, config=vcfg.target)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    log(f"V1: one block-view CG iteration's device kernels: {names}")
    if not names or not all(any(h in nm for h in hand) for nm in names) or not all(
            any(h in nm for nm in names) for h in hand):
        raise AssertionError(f"V1: the block-view iteration ran other kernels than the hand "
                             f"ones {hand}: {names}")
    del ul, bl, res, o, n
    torch.cuda.empty_cache()
    return dict(layout=lay.name, plan=block.describe(), ms_per_iteration=ms_it,
                iterations=iterations, kernels=names)


def view_block_ludwig(state, after_steps, cfg):
    """V1's Ludwig half: LUDWIG_STEPS steps in V1_LUDWIG_LAYOUT under the
    block plan, bitwise L3's; the misaligned layout refused before a launch."""
    lay = parse_layout(V1_LUDWIG_LAYOUT)
    lb = ludwig.lb_step_graph(cfg)
    check_block_view(lb, ("dist2", "u"), cfg.lattice, lay)
    block = LoweringPlan("cuda", vvl=cfg.target.vvl, bx=1, view="block")
    vcfg = dataclasses.replace(cfg, layout=lay,
                               target=dataclasses.replace(cfg.target, plan_policy=block))
    s = ludwig.LudwigState(dist=state.dist.as_layout(lay), q=state.q.as_layout(lay))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LUDWIG_STEPS):
        s = step(s, vcfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / LUDWIG_STEPS * 1e3
    counts = path_counts(LUDWIG_PATH)
    exact_err(s.dist.canonical(), after_steps.dist.data, "V1: dist against L3's")
    exact_err(s.q.canonical(), after_steps.q.data, "V1: q against L3's")
    # the step's kernels (ludwig_fed and K2 run in diagnostics, not in a step)
    idle = [n for n, c in counts.items() if c == 0 and n in ("lb_step", "ludwig_chem_stress",
                                                             "ludwig_lc_update")]
    if idle:
        raise AssertionError(f"V1: kernels of the step never launched: {idle}")
    bad = parse_layout(V1_MISALIGNED)
    fins = {"dist": state.dist.as_layout(bad),
            "force": Field.from_canonical("force", torch.zeros((3, state.dist.nsites),
                                                               device=state.dist.device),
                                          cfg.lattice, bad)}
    launches = k8.LB_STEP.launches
    try:
        lb.launch(fins, config=vcfg.target, outputs=("dist2", "u"))
    except ValueError as e:
        if "halo'd inner-plane" not in str(e) or k8.LB_STEP.launches != launches:
            raise
        log(f"V1: {bad.name} under the block plan refused before a launch: {e}")
    else:
        raise AssertionError(f"V1: a misaligned block view ({bad.name}) did not raise")
    log(f"V1: ludwig {cfg.lattice} in {lay.name} under {block.describe()}: {ms:.3f} ms/step, "
        f"dist and q bitwise L3's; launches {counts}")
    del s, fins
    torch.cuda.empty_cache()
    return dict(layout=lay.name, ms_per_step=ms)


def split_fold_cases(tbl, vvl):
    """RS1's K2S checks: single, 4 slots and compensated on ``tbl`` (rows,
    ncomp) and on its first 1 and 3 rows, bitwise fold_tree_split on the
    card at every factor of RS_FACTORS."""
    slots = torch.stack([tbl, tbl * 0.5, -tbl, tbl * 3.0])
    pairs = torch.stack([tbl, tbl * 2.0 ** -30], dim=-1)
    for t, sl, pr in ((tbl, slots, pairs),) + tuple(
            (tbl[:r], slots[:, :r].contiguous(), pairs[:r]) for r in RS_SMALL_ROWS):
        for rs in RS_FACTORS:
            what = f"RS1 K2S, {t.shape[0]} rows, rsplit {rs}"
            tree_err(reduce.fold_partials(t, "sum", rsplit=rs),
                     reduce.fold_tree_split(t, rsplit=rs), what)
            tree_err(reduce.fold_partials_batched(sl, "sum", rsplit=rs),
                     reduce.fold_tree_split(sl, rsplit=rs), f"{what}, {SLOTS} slots")
            tree_err(reduce.fold_partials(pr, "sum", compensated=True, rsplit=rs),
                     reduce.fold_tree_split(pr, compensated=True, rsplit=rs),
                     f"{what}, compensated")
            exact_err(reduce.fold_partials(t, "max", rsplit=rs), t.amax(dim=0), f"{what}, max")
    log(f"RS1: K2S (single, {SLOTS} slots, compensated) bitwise fold_tree_split at rsplit "
        f"{RS_FACTORS} on {tuple(tbl.shape)} and {RS_SMALL_ROWS} rows")
    return slots, pairs


def split_reductions(cfg, u, b, x_soa, iterations, vvl, state, lcfg):
    """RS1 (see the module docstring); returns (rows, line, counts)."""
    rows, line, counts = {}, {}, {}
    split = LoweringPlan("cuda", vvl=vvl, bx=1, rsplit=RSPLIT)
    scfg = dataclasses.replace(cfg, target=dataclasses.replace(cfg.target, plan_policy=split))
    # the split solve
    reset_counts()
    res, solve_s = solve_timed(scfg, u, b)
    counts.update(path_counts(RS_PATH))
    unsplit = reduce.REDUCE_FOLD.launches
    rc = residual_check(scfg, u, b, res.x)
    rel = rel_l2(res.x.data, x_soa)
    ms_it = solve_s / max(res.iterations, 1) * 1e3
    log(f"RS1: solve {cfg.lattice} under {split.describe()}: {res.iterations} iterations "
        f"(phase 4: {iterations}), {ms_it:.3f} ms/iter, |Mx-b|/|b| = {rc:.3e}, x rel-L2 "
        f"{rel:.3e} from phase 4's; launches {counts}, the unsplit fold {unsplit}")
    if abs(res.iterations - iterations) > 1 or not rel <= 1e-4 or not rc < 1e-3:
        raise AssertionError("RS1: the split solve is off phase 4's")
    if unsplit:
        raise AssertionError(f"RS1: the unsplit fold ran {unsplit} times in the split solve")
    idle = [n for n, c in counts.items() if c == 0]
    if idle:
        raise AssertionError(f"RS1: kernels of the split path never launched: {idle}")
    again = solve(scfg, u, b)
    exact_err(again.x.data, res.x.data, "RS1: the split solve run twice")
    # the split batched solve: each slot bitwise the split solve
    reset_counts()
    bres = solve_batched(scfg, u, [b, b])
    counts.update(path_counts(RS_BATCH_PATH))
    for k in range(2):
        exact_err(bres.x.element(k).data, res.x.data, f"RS1: batched slot {k} vs the split solve")
        if int(bres.iterations[k]) != res.iterations:
            raise AssertionError(f"RS1: batched slot {k} took {int(bres.iterations[k])} "
                                 f"iterations, the split solve {res.iterations}")
    # the split refined solve: K5's policy pap folded by K2S compensated
    reset_counts()
    rres, rs_s = solve_timed(dataclasses.replace(scfg, storage="bfloat16"), u, b)
    counts.update(path_counts(RS_COMP_PATH))
    rrc = residual_check(cfg, u, b, rres.x)
    rrel = rel_l2(rres.x.data, x_soa)
    log(f"RS1: solve_batched of 2 x b bitwise the split solve; refined split solve "
        f"{rres.iterations} inner iterations, {rs_s:.3f} s, |Mx-b|/|b| = {rrc:.3e}, x rel-L2 "
        f"{rrel:.3e}; launches {counts}")
    if not rrc < 1e-3 or not rrel < MIXED_REL_X:
        raise AssertionError("RS1: the refined split solve is off phase 4's")
    idle = [n for n in (*RS_BATCH_PATH, *RS_COMP_PATH) if counts[n] == 0]
    if idle:
        raise AssertionError(f"RS1: kernels never launched: {idle}")
    line.update(solve_ms_per_iteration=ms_it, iterations=res.iterations, x_rel_l2=rel,
                residual_check=rc, refined_iterations=rres.iterations, refined_s=rs_s)
    del res, again, bres, rres
    torch.cuda.empty_cache()

    # K2S on phase 3's partial tables, timed
    inp = milc_inputs(u, b, vvl)
    tbl = inp["partials"]
    slots, pairs = split_fold_cases(tbl, vvl)
    nc = tbl.shape[1]
    folds = {}
    for name, fn, plain, lib, nbytes in (
            ("reduce_fold_split", lambda: reduce.fold_partials(tbl, "sum", rsplit=RSPLIT),
             lambda: reduce.split_plain(tbl, "sum", RSPLIT), lambda: torch.sum(tbl, dim=0),
             tbl.numel() * 4 + 4 * nc),
            ("reduce_fold_split_batched",
             lambda: reduce.fold_partials_batched(slots, "sum", rsplit=RSPLIT),
             lambda: torch.stack([reduce.split_plain(t, "sum", RSPLIT) for t in slots]),
             lambda: torch.sum(slots, dim=1), slots.numel() * 4 + 4 * SLOTS * nc),
            ("reduce_fold_split_comp",
             lambda: reduce.fold_partials(pairs, "sum", compensated=True, rsplit=RSPLIT),
             lambda: reduce.compensated_plain(pairs, dim=(0, 2)),
             lambda: torch.sum(pairs.double(), dim=(0, 2)), pairs.numel() * 4 + 4 * nc)):
        add_row(rows, name, 0.0, time_ms(fn), time_ms(plain), nbytes, nbytes // 4,
                library_ms=time_ms(lib))
        unsplit = ((lambda: reduce.fold_partials(tbl, "sum")) if name == "reduce_fold_split"
                   else (lambda: reduce.fold_partials_batched(slots, "sum"))
                   if name.endswith("batched")
                   else (lambda: reduce.fold_partials(pairs, "sum", compensated=True)))
        folds[name] = dict(graph_ms=graph_ms(fn), graph_library_ms=graph_ms(lib),
                           unsplit_ms=time_ms(unsplit), unsplit_graph_ms=graph_ms(unsplit))
        log(f"  {name}: from a CUDA graph {folds[name]['graph_ms']:.4f} ms (torch.sum "
            f"{folds[name]['graph_library_ms']:.4f}); the unsplit fold a call "
            f"{folds[name]['unsplit_ms']:.4f} ms, from a graph "
            f"{folds[name]['unsplit_graph_ms']:.4f}")
    # the fused kernels' field outputs do not change with the split
    psi, uu, y, p, ap, alpha = (inp[n] for n in ("psi", "u", "y", "p", "ap", "alpha"))
    whole = fuse.cg_update(psi, y, p, ap, alpha, -alpha, vvl)
    parts = fuse.cg_update(psi, y, p, ap, alpha, -alpha, vvl, rsplit=RSPLIT)
    exact_err(parts[0], whole[0], "RS1: cg_update x_new split vs unsplit")
    exact_err(parts[1], whole[1], "RS1: cg_update r_new split vs unsplit")
    sum_err(parts[2], whole[2], whole[1] * whole[1], "RS1: cg_update rr split vs unsplit")
    wn = wk.wilson_normal_cuda(psi, uu, KAPPA, cfg.lattice, vvl)
    ws = wk.wilson_normal_cuda(psi, uu, KAPPA, cfg.lattice, vvl, rsplit=RSPLIT)
    exact_err(ws[0], wn[0], "RS1: wilson_normal ap split vs unsplit")
    sum_err(ws[1], wn[1], psi * wn[0], "RS1: wilson_normal pap split vs unsplit")
    log("RS1: cg_update's and wilson_normal's field outputs bitwise the unsplit launch")
    del inp, tbl, slots, pairs, whole, parts, wn, ws, psi, uu, y, p, ap
    torch.cuda.empty_cache()

    # the int32 and bf16 instances
    V, dev = math.prod(cfg.lattice), b.data.device
    gen = torch.Generator(device=dev).manual_seed(5)
    xi = torch.randint(-2**24, 2**24, (24, V), generator=gen, device=dev, dtype=torch.int32)
    xi[RS_WRAP_COMP] = 2**30 + 7
    want_i = {"sum": xi.sum(dim=1, dtype=torch.int32), "max": xi.amax(dim=1)}
    wide = int(xi[RS_WRAP_COMP].double().sum())
    if int(want_i["sum"][RS_WRAP_COMP]) == wide:
        raise AssertionError("RS1: the int32 field's sum does not pass 2^31")
    for spec in ("soa", "aos", "aosoa16"):
        lay = parse_layout(spec)
        xl = lay.pack(xi)
        for op, w in want_i.items():
            exact_err(reduce.reduce_sites(xl, op, vvl, layouts={"x": lay}), w,
                      f"RS1: int32 {op} in {spec}")
            exact_err(reduce.reduce_sites(xl, op, vvl, layouts={"x": lay}, rsplit=RSPLIT), w,
                      f"RS1: int32 {op} in {spec}, rsplit {RSPLIT}")
        del xl
    log(f"RS1: int32 sum (component {RS_WRAP_COMP}: {wide} wraps to "
        f"{int(want_i['sum'][RS_WRAP_COMP])}) and max bitwise torch's in soa, aos, aosoa16, "
        f"unsplit and at rsplit {RSPLIT}")
    itbl = torch.randint(-2**30, 2**30, (reduce.partial_rows(V), 24), generator=gen, device=dev,
                         dtype=torch.int32)
    nb = 96 * V
    for op, lib in (("sum", lambda: torch.sum(xi, dim=1, dtype=torch.int32)),
                    ("max", lambda: torch.amax(xi, dim=1))):
        add_row(rows, f"reduce_{op}_i32", 0.0, time_ms(lambda: reduce.reduce_sites(xi, op, vvl)),
                time_ms(lambda: reduce.reduce_plain(xi, op)), nb, 24 * V,
                library_ms=time_ms(lib))
    exact_err(reduce.fold_partials(itbl, "sum"), itbl.sum(dim=0, dtype=torch.int32),
              "RS1: int32 fold")
    add_row(rows, "reduce_fold_i32", 0.0, time_ms(lambda: reduce.fold_partials(itbl, "sum")),
            time_ms(lambda: reduce.reduce_plain(itbl, "sum", dim=0)), itbl.numel() * 4 + 96,
            itbl.numel(), library_ms=time_ms(lambda: torch.sum(itbl, dim=0, dtype=torch.int32)))
    # a bf16 field: the LB step's dist2 under bf16 storage (P4's)
    bcfg = dataclasses.replace(lcfg, storage="bfloat16")
    force = Field.from_canonical("force", torch.zeros((3, state.dist.nsites), device=dev),
                                 bcfg.lattice)
    d16 = ludwig.lb_step_graph(bcfg).launch(
        {"dist": state.dist, "force": force}, config=ludwig._lb_target(bcfg),
        outputs=("dist2",))["dist2"].data
    if d16.dtype != torch.bfloat16:
        raise AssertionError(f"RS1: the bf16 LB step wrote {d16.dtype}")
    LV = state.dist.nsites
    got = reduce.reduce_sites(d16, "sum", vvl)
    tree_err(got, reduce.reduce_tree(d16), "RS1: bf16 sum")
    want = d16.double().sum(dim=1).to(torch.bfloat16)
    err = (got.double() - want.double()).abs()
    ulp = torch.pow(2.0, torch.floor(torch.log2(want.double().abs())) - 7)
    if not bool((err <= ulp).all()):
        raise AssertionError(f"RS1: bf16 sum {err.max().item()} from the fp64 sum, beyond an ulp")
    exact_err(reduce.reduce_sites(d16, "max", vvl), d16.amax(dim=1), "RS1: bf16 max")
    log(f"RS1: bf16 sum of the bf16 dist2 at {bcfg.lattice} bitwise its tree, within one ulp "
        f"of the fp64 sum rounded (max err {err.max().item():.3e}); max bitwise amax")
    nb16 = 19 * 2 * LV
    add_row(rows, "reduce_sum_bf16", err.max().item(),
            time_ms(lambda: reduce.reduce_sites(d16, "sum", vvl)),
            time_ms(lambda: reduce.reduce_plain(d16, "sum")), nb16, 19 * LV,
            library_ms=time_ms(lambda: torch.sum(d16, dim=1)))
    add_row(rows, "reduce_max_bf16", 0.0, time_ms(lambda: reduce.reduce_sites(d16, "max", vvl)),
            time_ms(lambda: reduce.reduce_plain(d16, "max")), nb16, 19 * LV,
            library_ms=time_ms(lambda: torch.amax(d16, dim=1)))
    ftbl = torch.randn((reduce.partial_rows(LV), 19), generator=gen, device=dev)
    tree_err(reduce.fold_partials(ftbl, "sum", out_dtype=torch.bfloat16),
             reduce.fold_tree(ftbl).to(torch.bfloat16), "RS1: bf16 fold")
    add_row(rows, "reduce_fold_bf16", 0.0,
            time_ms(lambda: reduce.fold_partials(ftbl, "sum", out_dtype=torch.bfloat16)),
            time_ms(lambda: reduce.reduce_plain(ftbl, "sum", dim=0).to(torch.bfloat16)),
            ftbl.numel() * 4 + 2 * 19, ftbl.numel(),
            library_ms=time_ms(lambda: torch.sum(ftbl, dim=0)))
    # the standalone reductions of those fields, counted (no driver path runs them)
    fi = Field.from_canonical("xi", xi, cfg.lattice)
    f16 = Field("dist2", 19, bcfg.lattice, SOA, d16)
    tgt = cfg.target
    reset_counts()
    for f in (fi, f16):
        reduce.target_sum(f, tgt)
        reduce.target_max(f, tgt)
    counts.update(path_counts(RS_DTYPE_PATH))
    idle = [n for n in RS_DTYPE_PATH if counts[n] == 0]
    if idle:
        raise AssertionError(f"RS1: kernels of the standalone reductions never launched: {idle}")
    log(f"RS1: the standalone int32 and bf16 reductions' window: "
        f"{path_counts(RS_DTYPE_PATH)}")
    del xi, itbl, d16, ftbl, fi, f16, force
    torch.cuda.empty_cache()
    line["folds"] = folds   # the rows themselves go into the kernel table
    return rows, line, counts


# -- U1, U2: the flat chains' policy instances and the plan autotuner -------------------

def check_flat_policy_milc(u, b, lattice, vvl):
    """U1 at the MILC lattice: K3's policy instance against its plain version
    in U1_LAYOUTS: under bf16 storage x_new and r_new within one bf16 ulp, rr
    within the oracle bound of the fp32 r_new's squares (the kernel's own:
    the accumulate-only instance on the pre-rounded inputs); under the
    accumulate-only policy the fields bitwise the policy-free kernel's; the
    same bits run to run; bf16 inputs bitwise their fp32 sources
    pre-rounded.  Timed in SoA beside the policy-free kernel.  Returns
    (rows, extra)."""
    V = math.prod(lattice)
    inp = milc_inputs(u, b, vvl)
    psi, y, p, ap, alpha, neg_alpha = (inp[n] for n in ("psi", "y", "p", "ap", "alpha",
                                                        "neg_alpha"))
    pol, acc = CudaPolicy(True, True), CudaPolicy(False, True)
    rows, extra = {}, {}
    for spec in U1_LAYOUTS:
        lay = parse_layout(spec)
        cl = {n: lay for n in ("x", "r", "p", "ap", "x_new", "r_new")}
        ins = [t if lay == SOA else lay.pack(t) for t in (psi, y, p, ap)]
        got = fuse.cg_update(*ins, alpha, neg_alpha, vvl, layouts=cl, policy=pol)
        want = fuse.cg_update_plain(*ins, alpha, neg_alpha, cl, policy=pol)
        if got[0].dtype != torch.bfloat16 or got[1].dtype != torch.bfloat16:
            raise AssertionError(f"U1 {spec} cg_update policy: fields not in bf16")
        err = max(bf16_err(lay.unpack(got[k]), lay.unpack(want[k]), f"U1 {spec} cg_update "
                           f"policy {('x_new', 'r_new')[k]}") for k in range(2))
        own = fuse.cg_update(*(wk.bf16_round(t) for t in ins), alpha, neg_alpha, vvl,
                             layouts=cl, policy=acc)
        r32 = lay.unpack(own[1])
        oracle_err(got[2], r32 * r32, f"U1 {spec} cg_update policy rr")
        oracle_err(want[2], r32 * r32, f"U1 {spec} cg_update plain policy rr")
        free = fuse.cg_update(*ins, alpha, neg_alpha, vvl, layouts=cl)
        a32 = fuse.cg_update(*ins, alpha, neg_alpha, vvl, layouts=cl, policy=acc)
        for k in range(2):
            bits_err(a32[k], free[k], f"U1 {spec} cg_update accumulate-only field {k}")
        rf = lay.unpack(free[1])
        oracle_err(a32[2], rf * rf, f"U1 {spec} cg_update accumulate-only rr")
        again = fuse.cg_update(*ins, alpha, neg_alpha, vvl, layouts=cl, policy=pol)
        g16 = fuse.cg_update(*(t.to(torch.bfloat16) for t in ins), alpha, neg_alpha, vvl,
                             layouts=cl, policy=pol)
        for k in range(3):
            bits_err(again[k].float(), got[k].float(), f"U1 {spec} cg_update policy run to run")
            bits_err(g16[k].float(), got[k].float(), f"U1 {spec} cg_update policy, bf16 inputs")
        log(f"  U1 {spec}: cg_update policy x_new, r_new within one bf16 ulp, rr within the "
            f"oracle bound; accumulate-only fields bitwise the policy-free K3; run to run "
            f"and bf16 inputs bitwise")
        del got, want, own, free, a32, again, g16, r32, rf
        if lay == SOA:
            free_ms = time_ms(lambda: fuse.cg_update(psi, y, p, ap, alpha, neg_alpha, vvl))
            add_row(rows, "cg_update_policy", err,
                    time_ms(lambda: fuse.cg_update(psi, y, p, ap, alpha, neg_alpha, vvl,
                                                   policy=pol)),
                    time_ms(lambda: fuse.cg_update_plain(psi, y, p, ap, alpha, neg_alpha,
                                                         policy=pol)),
                    (4 * 24 * 4 + 2 * 24 * 2) * V, 24 * 6 * V)
            parts = {f"{'bf16' if bf else 'fp32'}_{'comp' if cp else 'plain'}_ms":
                     time_ms(lambda bf=bf, cp=cp: fuse.cg_update(
                         psi, y, p, ap, alpha, neg_alpha, vvl, policy=CudaPolicy(bf, cp)))
                     for bf, cp in ((True, False), (False, True))}
            extra["cg_update_policy"] = dict(policy_free_ms=free_ms,
                                             policy_free_bound_ms=576 * V / HBM_BYTES_PER_S * 1e3,
                                             **parts)
            log(f"    cg_update_policy: policy-free K3 {free_ms:.4f} ms; bf16 storage alone, "
                f"the compensated rr alone {parts}")
        del ins
        torch.cuda.empty_cache()
    return rows, extra


def check_flat_policy_ludwig(state, cfg, vvl):
    """U1 at the Ludwig lattice: K3L's policy instances (chem_stress,
    lc_update) against their plain versions in U1_LAYOUTS on L2's inputs,
    with U1's MILC checks (the accumulate-only policy runs the policy-free
    kernels: these graphs have no sums).  Timed in SoA beside the
    policy-free kernels.  Returns (rows, extra)."""
    V = state.q.nsites
    inp = ludwig_inputs(state, vvl)
    pol, acc = CudaPolicy(True, True), CudaPolicy(False, True)
    cs_kw = dict(a0=cfg.a0, gamma=cfg.gamma, kappa_m=cfg.kappa, kappa_s=cfg.kappa, xi=cfg.xi)
    lu_kw = dict(gamma_rot=cfg.gamma_rot, xi=cfg.xi, dt=cfg.dt)
    cases = (
        ("ludwig_chem_stress_policy", ("q", "lapq", "dq"), ("h", "sigma"), lk.chem_stress_cuda,
         lk.chem_stress_plain, cs_kw, (25 * 4 + 14 * 2), 156, FLOPS["chem_stress"]),
        ("ludwig_lc_update_policy", ("q", "h", "w", "adv"), ("q_new",), lk.lc_update_cuda,
         lk.lc_update_plain, lu_kw, (24 * 4 + 5 * 2), 116, FLOPS["lc_update"]))
    rows, extra = {}, {}
    for name, names, outs, kern, plain_fn, kw, nbytes, free_bytes, flops in cases:
        for spec in U1_LAYOUTS:
            lay = parse_layout(spec)
            lays = {n: lay for n in names + outs}
            ins = [inp[n] if lay == SOA else lay.pack(inp[n]) for n in names]

            def fields(r):
                return r if isinstance(r, tuple) else (r,)

            got = fields(kern(*ins, vvl=vvl, layouts=lays, policy=pol, **kw))
            want = fields(plain_fn(*ins, layouts=lays, policy=pol, **kw))
            if any(t.dtype != torch.bfloat16 for t in got):
                raise AssertionError(f"U1 {spec} {name}: fields not in bf16")
            err = max(bf16_err(lay.unpack(g), lay.unpack(w), f"U1 {spec} {name} {o}")
                      for g, w, o in zip(got, want, outs))
            for g, a in zip(got, fields(kern(*ins, vvl=vvl, layouts=lays, policy=pol, **kw))):
                bits_err(a.float(), g.float(), f"U1 {spec} {name} run to run")
            g16 = fields(kern(*(t.to(torch.bfloat16) for t in ins), vvl=vvl, layouts=lays,
                              policy=pol, **kw))
            for g, a in zip(got, g16):
                bits_err(a.float(), g.float(), f"U1 {spec} {name}, bf16 inputs")
            free = fields(kern(*ins, vvl=vvl, layouts=lays, **kw))
            for f, a in zip(free, fields(kern(*ins, vvl=vvl, layouts=lays, policy=acc, **kw))):
                bits_err(a, f, f"U1 {spec} {name} accumulate-only")
            log(f"  U1 {spec}: {name} fields within one bf16 ulp; accumulate-only bitwise the "
                f"policy-free K3L; run to run and bf16 inputs bitwise")
            del got, want, g16, free
            if lay == SOA:
                free_ms = time_ms(lambda: kern(*ins, vvl=vvl, **kw))
                add_row(rows, name, err, time_ms(lambda: kern(*ins, vvl=vvl, policy=pol, **kw)),
                        time_ms(lambda: plain_fn(*ins, policy=pol, **kw), reps=3, warm=1),
                        nbytes * V, flops * V)
                extra[name] = dict(policy_free_ms=free_ms,
                                   policy_free_bound_ms=free_bytes * V / HBM_BYTES_PER_S * 1e3)
                log(f"    {name}: policy-free K3L {free_ms:.4f} ms")
            del ins
            torch.cuda.empty_cache()
    return rows, extra


def winners_line(results):
    """A tuner's results as {graph: {winner, candidates' µs, failed, rejected}},
    logged."""
    out = {}
    for gname, (plan_, info) in results.items():
        out[gname] = {"winner": plan_.describe(), "timings_us": info.get("timings_us"),
                      "failed": info.get("failed"), "rejected": info.get("rejected"),
                      "default": info["default"].describe() if "default" in info else None}
        log(f"  U2 {gname}: winner {plan_.describe()} (default "
            f"{out[gname]['default']}); µs {info.get('timings_us')}; failed "
            f"{info.get('failed')}; rejected {info.get('rejected')}")
    return out


def tuned_phase(cfg, u, b, x_soa, iterations, solve_s, state, after_steps, lcfg, l3_ms, small,
                seed):
    """U2: the plan autotuner on the card, with $TARGETDP_TORCH_TUNE_PATH a
    fresh temporary file.  Counted: tune_solve_graphs (convergence cost) at
    the MILC lattice and tune_step_graphs at the Ludwig lattice, every
    candidate lowering (failed empty), the policy instances launched; a
    second call of each cached with no sweep launch; a plan_policy="tuned"
    solve and 10 tuned Ludwig steps, counted, running their winners'
    kernels and, where no winner carries a dtype policy, phase 4's solve
    (iterations within 1, x within rel-L2 1e-5) and L3's steps bitwise;
    a recorded bf16 winner for wilson_normal driving a storage="bfloat16"
    solve to |M x - b| / |b| < 1e-3; a SolveServer drain at ``small`` under
    "tuned" bitwise the default drain.  Returns (the sweep window's counts,
    the phase's line)."""
    tmp = tempfile.mkdtemp(prefix="targetdp_tune_")
    os.environ[tune.ENV_VAR] = os.path.join(tmp, "tune.json")
    tune.clear_table_cache()
    tune.reset_stats()
    line = {}
    try:
        reset_counts()
        t0 = time.perf_counter()
        mres = tune_solve_graphs(cfg, u, b, convergence_cost=True)
        t1 = time.perf_counter()
        lres = ludwig.tune_step_graphs(lcfg, state)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        sweep_counts = path_counts(FLAT_POLICY_PATH)
        sweeps = tune.stats()["sweep_launches"]
        log(f"U2: tune_solve_graphs at {cfg.lattice} {t1 - t0:.2f} s, tune_step_graphs at "
            f"{lcfg.lattice} {t2 - t1:.2f} s, {sweeps} sweep launches; the policy instances' "
            f"launches {sweep_counts}")
        line["winners"] = {**winners_line(mres), **winners_line(lres)}
        line["sweep_s"] = {"milc": t1 - t0, "ludwig": t2 - t1}
        failed = {g: info["failed"] for g, (_, info) in {**mres, **lres}.items() if info["failed"]}
        if failed:
            raise AssertionError(f"U2: candidates failed to lower: {failed}")
        idle = [n for n, c in sweep_counts.items() if c == 0]
        if idle:
            raise AssertionError(f"U2: policy instances never launched by the sweep: {idle}")
        again = {**tune_solve_graphs(cfg, u, b, convergence_cost=True),
                 **ludwig.tune_step_graphs(lcfg, state)}
        if not all(info["cached"] for _, info in again.values()) or \
                tune.stats()["sweep_launches"] != sweeps:
            raise AssertionError("U2: a second tune was not a cached table hit")
        log("U2: the second tune_solve_graphs and tune_step_graphs: cached, no sweep launch")
        op, upd = mres["wilson_normal"][0], mres["cg_update"][0]

        # the tuned solve, counted, beside a default solve in the same window
        tcfg = dataclasses.replace(cfg, target=dataclasses.replace(cfg.target,
                                                                   plan_policy="tuned"))
        dres, ddt = solve_timed(cfg, u, b)
        dms_it = ddt / max(dres.iterations, 1) * 1e3
        del dres
        reset_counts()
        tune.reset_stats()
        res, dt = solve_timed(tcfg, u, b)
        counts = {k.name: k.launches for k in KERNELS if k.launches}
        rel = (torch.linalg.norm(res.x.data.float() - x_soa)
               / torch.linalg.norm(x_soa)).item()
        ms_it = dt / max(res.iterations, 1) * 1e3
        log(f"U2: tuned solve: {res.iterations} iterations (phase 4: {iterations}), {dt:.3f} s, "
            f"{ms_it:.3f} ms/iter (phase 4: {solve_s / iterations * 1e3:.3f}; a default solve "
            f"just before: {dms_it:.3f}), residual "
            f"{float(res.residual):.3e}, x rel-L2 {rel:.3e} from phase 4's; table hits "
            f"{tune.stats()['hits']}; launches {counts}")
        want = ([wk.WILSON_NORMAL_AP_TILED_MIXED if op.dtypes else wk.WILSON_NORMAL_AP_TILED]
                if op.tiled else [wk.WILSON_NORMAL_AP_MIXED if op.dtypes else wk.WILSON_NORMAL_AP])
        # a bf16 ap (an operator winner with bf16 storage) keys the update
        # chain off the table: it then runs the ap16 instance by default
        want.append(fuse.CG_UPDATE_AP16 if op.dtypes else
                    (fuse.CG_UPDATE_POLICY if upd.dtypes else fuse.CG_UPDATE))
        idle = [k.name for k in want if not k.launches]
        if idle or not tune.stats()["hits"]:
            raise AssertionError(f"U2: the tuned solve did not run its winners' kernels {idle} "
                                 f"(hits {tune.stats()['hits']})")
        if not torch.isfinite(res.x.data.float()).all() or not math.isfinite(float(res.residual)):
            raise AssertionError("U2: the tuned solve is not finite")
        if not (op.dtypes or upd.dtypes):
            if abs(res.iterations - iterations) > 1 or not rel <= 1e-5:
                raise AssertionError("U2: the tuned solve is off phase 4's")
        line["solve"] = dict(iterations=res.iterations, phase4_iterations=iterations,
                             ms_per_iteration=ms_it, default_ms_per_iteration=dms_it,
                             phase4_ms_per_iteration=solve_s / iterations * 1e3,
                             residual=float(res.residual), x_rel_l2=rel, launches=counts)
        del res

        # 10 tuned Ludwig steps, counted
        tl = dataclasses.replace(lcfg, target=dataclasses.replace(lcfg.target,
                                                                  plan_policy="tuned"))
        lplans = {g: p_ for g, (p_, _) in lres.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = state
        for _ in range(LUDWIG_STEPS):
            s = step(s, lcfg)
        torch.cuda.synchronize()
        dstep_ms = (time.perf_counter() - t0) / LUDWIG_STEPS * 1e3
        reset_counts()
        tune.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = state
        for _ in range(LUDWIG_STEPS):
            s = step(s, tl)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / LUDWIG_STEPS * 1e3
        counts = {k.name: k.launches for k in KERNELS if k.launches}
        lb = lplans["ludwig_lb_step"]
        want = [((k8.LB_STEP_TILED_BF16 if lb.dtypes else k8.LB_STEP_TILED) if lb.tiled
                 else (k8.LB_STEP_BF16 if lb.dtypes else k8.LB_STEP)),
                lk.CHEM_STRESS_POLICY if lplans["ludwig_chem_stress"].dtypes else lk.CHEM_STRESS,
                lk.LC_UPDATE_POLICY if lplans["ludwig_lc_update"].dtypes else lk.LC_UPDATE]
        idle = [k.name for k in want if not k.launches]
        log(f"U2: 10 tuned Ludwig steps {step_ms:.3f} ms/step (L3: {l3_ms:.3f}; 10 default "
            f"steps just before: {dstep_ms:.3f}); table hits "
            f"{tune.stats()['hits']}; launches {counts}")
        if idle or tune.stats()["hits"] != 3 * LUDWIG_STEPS:
            raise AssertionError(f"U2: the tuned steps did not run their winners' kernels {idle} "
                                 f"(hits {tune.stats()['hits']})")
        if any(p_.dtypes for p_ in lplans.values()):
            diag = {k: v.tolist() for k, v in ludwig.diagnostics(s, lcfg).items()}
            log(f"U2: a Ludwig winner carries a dtype policy: diagnostics after 10 steps {diag}")
            for t in (s.q.data, s.dist.data):
                if not torch.isfinite(t).all():
                    raise AssertionError("U2: the tuned steps are not finite")
            line["steps_bitwise_l3"] = False
            line["steps_diagnostics"] = diag
        else:
            exact_err(s.dist.data, after_steps.dist.data, "U2 tuned steps' dist vs L3's")
            exact_err(s.q.data, after_steps.q.data, "U2 tuned steps' q vs L3's")
            log("U2: the tuned steps are bitwise L3's")
            line["steps_bitwise_l3"] = True
        line["steps"] = dict(ms_per_step=step_ms, default_ms_per_step=dstep_ms,
                             l3_ms_per_step=l3_ms, launches=counts)
        del s

        # a recorded bf16 winner drives the refined solve
        g = cg_mod.wilson_normal_graph(float(cfg.kappa))
        key = g.plan_key({"p": b, "u": u}, config=cfg.target, outputs=("ap", "pap"))
        tune.record(key, dataclasses.replace(mres["wilson_normal"][1]["default"], dtypes=BF16))
        rcfg = dataclasses.replace(tcfg, storage="bfloat16")
        reset_counts()
        tune.reset_stats()
        res, dt = solve_timed(rcfg, u, b)
        rc = residual_check(cfg, u, b, res.x)
        log(f"U2: a recorded bf16 operator winner: refined solve {res.iterations} iterations, "
            f"{dt:.3f} s, |Mx-b|/|b| = {rc:.3e}; table hits {tune.stats()['hits']}; "
            f"K5's policy instance {wk.WILSON_NORMAL_AP_MIXED.launches} launches, bf16 copies "
            f"of u {wk.BF16_PACK.launches}")
        if not rc < 1e-3 or not tune.stats()["hits"] or not wk.WILSON_NORMAL_AP_MIXED.launches:
            raise AssertionError("U2: the recorded bf16 winner did not drive the refined solve")
        line["recorded_bf16"] = dict(iterations=res.iterations, seconds=dt, residual_check=rc,
                                     bf16_packs=wk.BF16_PACK.launches)
        del res

        # a SolveServer drain at --small under "tuned", bitwise the default drain
        scfg = dataclasses.replace(cfg, lattice=small)
        su, _ = init_problem(scfg, seed=0)
        srcs = [spinor(small, seed + 40 + i) for i in range(U2_DRAIN_REQUESTS)]
        outs = []
        for target_ in (cfg.target, tcfg.target):
            server = SolveServer(target_, slots=U2_DRAIN_SLOTS, tol=cfg.tol, max_iter=cfg.max_iter)
            server.register(su, cfg.kappa)
            for i, sb in enumerate(srcs):
                server.submit(SolveRequest(i, sb))
            outs.append(server.run())
        for rid, out in outs[1].items():
            exact_err(out.x.data, outs[0][rid].x.data, f"U2 tuned drain request {rid}")
            if out.iterations != outs[0][rid].iterations:
                raise AssertionError(f"U2 tuned drain request {rid}: iterations differ")
        log(f"U2: a SolveServer drain at {small} under plan_policy='tuned': "
            f"{len(outs[1])} outcomes bitwise the default drain's")
        del su, srcs, outs
    finally:
        os.environ.pop(tune.ENV_VAR, None)
        tune.clear_table_cache()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return sweep_counts, line


# the decomposed lattice (D1-D3): a one-rank mesh on the card, every lattice
# dim decomposed over an axis of size 1, so every exchange is the self-exchange
D_MILC_AXES, D_LUDWIG_AXES = ("x", "y", "z", "t"), ("x", "y", "z")
D_STEPS = 5
TRACE_RUNS = 3        # D2's trace: overlap operators in the session, the last one read
D_REL_X = 1e-4                       # D2: x within rel-L2 of phase 4's
D_STEP_RTOL, D_STEP_ATOL = 1e-4, 1e-6   # D3 where the steps are not bitwise
DECOMP_PATH = {
    "dslash_halo": ([wk.DSLASH_HALO], "wilson_halo.cu",
                    "src/repro/kernels/wilson_dslash/kernel.py:27"),
    "wilson_normal_pre": ([wk.WILSON_NORMAL_PRE_T, wk.WILSON_NORMAL_PRE_AP], "wilson_halo.cu",
                          "src/repro/core/fuse.py:1721"),
    "lb_propagate_halo": ([k8.PROPAGATE_HALO], "lb_halo.cu",
                          "src/repro/kernels/lb_propagation/kernel.py:30"),
    "lb_step_pre": ([k8.LB_STEP_PRE], "lb_halo.cu", "src/repro/core/fuse.py:1721"),
    # the halo="overlap" split's sub-launches: K5H and K5LH on one box
    "wilson_normal_box": ([wk.WILSON_NORMAL_BOX_T, wk.WILSON_NORMAL_BOX_AP], "wilson_halo.cu",
                          "src/repro/core/fuse.py:1721"),
    "lb_step_box": ([k8.LB_STEP_BOX], "lb_halo.cu", "src/repro/core/fuse.py:1721"),
    # the sharded plans: tiled "pre" launches and their layouts (K9H, K5TH)
    # and tiled overlap boxes (tiled K5HO), the TPU's tiled dma_kernel
    "lb_step_halo": ([k8.LB_STEP_HALO], "lb_halo.cu", "src/repro/core/fuse.py:1804"),
    "lb_step_halo@aosoa4": ([k8.LB_STEP_HALO], "lb_halo.cu", "src/repro/core/fuse.py:1721"),
    "wilson_normal_pre_tiled": ([wk.WILSON_NORMAL_PRE_T_TILED, wk.WILSON_NORMAL_PRE_AP_TILED],
                                "wilson_halo.cu", "src/repro/core/fuse.py:1804"),
    "wilson_normal_box_tiled": ([wk.WILSON_NORMAL_BOX_AP_TILED], "wilson_halo.cu",
                                "src/repro/core/fuse.py:1804"),
}
# D2's budgeted and tuned solves, D3's budgeted and block-view steps
K5HO_OUTER = LoweringPlan("cuda", vvl=128, bx=2, by=4, bz=4, halo="overlap")
K9H_COARSE_TILE = (16, 64, 0)   # 64 tiles at (256, 256, 256): the tiled plain version's loop
D3_BLOCK_PLAN = LoweringPlan("cuda", vvl=64, bx=1, view="block")
D2_PRE_TILED = {"wilson_normal_pre_tiled": DECOMP_PATH["wilson_normal_pre_tiled"]}
D2_BOX_TILED = {"wilson_normal_box_tiled": DECOMP_PATH["wilson_normal_box_tiled"]}
D_OPERATORS = 3       # D2's tiled overlap operators
D3_TILED = {"lb_step_halo": DECOMP_PATH["lb_step_halo"]}
# D2's paths: the sharded solve's kernels under each schedule (the rhs runs
# K4H and g5 under both)
_D2_COMMON = ("cg_update", "cg_xpay", "g5", "mul", "reduce_sum", "reduce_fold")
D2_PATHS = {
    None: {"dslash_halo": DECOMP_PATH["dslash_halo"], **{n: PATH[n] for n in _D2_COMMON}},
    "pre": {"wilson_normal_pre": DECOMP_PATH["wilson_normal_pre"],
            "dslash_halo": DECOMP_PATH["dslash_halo"], **{n: PATH[n] for n in _D2_COMMON}},
    "overlap": {"wilson_normal_box": DECOMP_PATH["wilson_normal_box"],
                "dslash_halo": DECOMP_PATH["dslash_halo"], **{n: PATH[n] for n in _D2_COMMON}},
}
_D3_COMMON = {n: LUDWIG_PATH[n] for n in ("ludwig_chem_stress", "ludwig_lc_update")}
D3_PATH = {"lb_step_pre": DECOMP_PATH["lb_step_pre"], **_D3_COMMON}
D3_OVERLAP_PATH = {"lb_step_box": DECOMP_PATH["lb_step_box"], **_D3_COMMON}
# K5HO's kernels an operator: the interior's t and ap, the boundary's
D2_OVERLAP_KERNELS = 4
# the kernels the split must not run: the whole "pre" launches
D2_NOT_OVERLAP = {"wilson_normal_pre": DECOMP_PATH["wilson_normal_pre"]}
D3_NOT_OVERLAP = {"lb_step_pre": DECOMP_PATH["lb_step_pre"]}


def one_rank_mesh(axes):
    """A mesh of one rank on this card: no process group."""
    return Mesh((1,) * len(axes), axes, rank=0, world_size=1, local_rank=0, device="cuda")


def wrap_pad(t_nd, w):
    return halo_pad(t_nd, w, range(1, t_nd.dim())).contiguous()


def face_sites(lat):
    """The sites of one width-1 face of each lattice dim, summed."""
    V = math.prod(lat)
    return sum(V // s for s in lat)


def edge_sites(lat):
    """The sites of one width-1 edge (sites one step out along two dims) of
    each pair of lattice dims, summed."""
    V = math.prod(lat)
    return sum(V // (lat[i] * lat[j]) for i in range(len(lat)) for j in range(i + 1, len(lat)))


def wilson_normal_pre_bytes(lat):
    """The bytes the M^dag M of a halo'd launch over ``lat`` (the whole
    interior or one box of its split) must move: ap needs t on the box and
    its 8 faces (S, V + 2F sites); t there needs p on S's faces and edges
    (V + 4F + 4E), u's 4 links on S, link mu a step below S along mu (F more
    sites) and two links on S's edges (72 values an edge of each pair of
    dims); ap's sites are written once."""
    V, F, E = math.prod(lat), face_sites(lat), edge_sites(lat)
    return 4 * (24 * (V + 4 * F + 4 * E) + 72 * (V + 2 * F) + 18 * F + 72 * E + 24 * V)


def wilson_normal_pre_ops(lat):
    """The flops of that M^dag M: t on S, then ap on the box."""
    V, F = math.prod(lat), face_sites(lat)
    return (1320 + 48) * (V + 2 * F + V)


def split_reread_bytes(lattice, tables, device):
    """The bytes K5HO's split of one M^dag M moves beyond K5H's: the p and
    u values both of its phases read (before the exchange: t on the
    interior's grown box and ap on the interior; after it: t on the shell
    and ap on the boundary), which one launch over the whole interior reads
    once.  t stays out, as in K5H's bound: the split computes each t site
    once and reads it where K5H does."""
    def phase(t_part, ap_part):
        _, p_sites, t_links = wk.table_reads(lattice, "t", tables[t_part][1], device)
        _, _, ap_links = wk.table_reads(lattice, "ap", tables[ap_part][1], device)
        return p_sites, [a | b_ for (a, _), (b_, _) in zip(t_links, ap_links)]

    p1, l1 = phase("interior t", "interior ap")
    p2, l2 = phase("shell t", "boundary ap")
    return 4 * (24 * int((p1 & p2).sum()) + 18 * sum(int((a & b_).sum()) for a, b_ in zip(l1, l2)))


def lb_step_pre_sites(lat):
    """The sites a halo'd LB half-step over ``lat`` (the whole interior or
    one box of its split) must collide: the box, its faces and edges
    (D3Q19 has no corner velocity)."""
    return math.prod(lat) + 2 * face_sites(lat) + 4 * edge_sites(lat)


def lb_step_pre_bytes(lat):
    """Its bytes: dist and force read on the collided sites, dist2 and u
    written on the box's."""
    return 22 * 4 * (lb_step_pre_sites(lat) + math.prod(lat))


def check_halo_milc(u, b, lattice, vvl):
    """D1 (MILC): K4H and K5H at the solve's lattice, on b and u
    wrap-padded (the one-rank exchange's values)."""
    V = math.prod(lattice)
    V1, V2 = math.prod(s + 2 for s in lattice), math.prod(s + 4 for s in lattice)
    F = face_sites(lattice)
    rows = {}
    psi_nd, u_nd = b.canonical_nd(), u.canonical_nd()
    psi_h, u_h = wrap_pad(psi_nd, 1), wrap_pad(u_nd, 1)
    got = wk.dslash_halo_cuda(psi_h, u_h, 1, vvl)
    err = field_err(got, wk.dslash_halo_plain(psi_h, u_h, 1), "dslash_halo")
    k4 = wk.dslash_cuda(b.data, u.data, lattice, vvl)
    log(f"  K4H against K4's periodic D psi: bitwise {torch.equal(got.reshape(24, -1), k4)}, "
        f"max abs diff {(got.reshape(24, -1) - k4).abs().max().item():.3e}; K4 "
        f"{time_ms(lambda: wk.dslash_cuda(b.data, u.data, lattice, vvl)):.4f} ms")
    add_row(rows, "dslash_halo", err, time_ms(lambda: wk.dslash_halo_cuda(psi_h, u_h, 1, vvl)),
            time_ms(lambda: wk.dslash_halo_plain(psi_h, u_h, 1), reps=3, warm=1),
            # the values D psi depends on: psi on the interior and its 8 faces,
            # u's 4 links on the interior and link mu on mu's low face
            4 * (24 * (V + 2 * F) + 72 * V + 18 * F + 24 * V), 1320 * V)
    del psi_h, u_h, got, k4
    torch.cuda.empty_cache()

    p_h, u_h = wrap_pad(psi_nd, 2).reshape(24, -1), wrap_pad(u_nd, 2).reshape(72, -1)
    got = wk.wilson_normal_pre_cuda(p_h, u_h, KAPPA, lattice, vvl)
    err = field_err(got, wk.wilson_normal_pre_plain(p_h, u_h, KAPPA, lattice), "wilson_normal_pre")
    k5, _ = wk.wilson_normal_cuda(b.data, u.data, KAPPA, lattice, vvl)
    floor = bound((24 + 72) * 4 * V2 + 2 * 24 * 4 * V1 + 72 * 4 * V2 + 24 * 4 * V, 0)[0]
    log(f"  K5H against K5's periodic ap: bitwise {torch.equal(got, k5)}, max abs diff "
        f"{(got - k5).abs().max().item():.3e}; K5 "
        f"{time_ms(lambda: wk.wilson_normal_cuda(b.data, u.data, KAPPA, lattice, vvl)):.4f} ms; "
        f"K5H's two-launch floor {floor:.4f} ms (t over {V1} sites, {V1 / V:.3f} V)")
    add_row(rows, "wilson_normal_pre", err,
            time_ms(lambda: wk.wilson_normal_pre_cuda(p_h, u_h, KAPPA, lattice, vvl)),
            time_ms(lambda: wk.wilson_normal_pre_plain(p_h, u_h, KAPPA, lattice), reps=3, warm=1),
            wilson_normal_pre_bytes(lattice), wilson_normal_pre_ops(lattice))
    del p_h, u_h, got, k5
    torch.cuda.empty_cache()
    return rows, floor


def split_of(lat, ring):
    """The overlap split of ``lat`` for ``ring`` with every dim decomposed:
    [interior, boundary slabs...], each as (origin, extents)."""
    interior, boundary = split_boxes(lat, ring, range(len(lat)))
    return [(tuple(a for a, _ in bx), tuple(b - a for a, b in bx)) for bx in [interior] + boundary]


def box_sl(o, e):
    return (slice(None),) + tuple(slice(a, a + b) for a, b in zip(o, e))


def check_box_milc(u, b, lattice, vvl):
    """D1 (MILC): K5HO on the full lattice's overlap split (ring 2, every
    dim decomposed: the interior and 8 slabs), on b and u wrap-padded: the
    interior's two launches (t on its grown box, ap on it), then the
    boundary's (t on the shell, ap on the 8 boxes, the T-slabs paired),
    within FIELD_RTOL of the plain box-table schedule and bitwise K5H on
    every site, t written on every ring-1 site; each part and each paired
    entry timed beside its byte bound and its sector bound (the 32-byte
    sectors its values lie in); the split timed against K5H in turns."""
    p_h, u_h = wrap_pad(b.canonical_nd(), 2).reshape(24, -1), wrap_pad(u.canonical_nd(), 2).reshape(72, -1)
    whole = wk.wilson_normal_pre_cuda(p_h, u_h, KAPPA, lattice, vvl)
    boxes = split_of(lattice, 2)
    V, V1 = math.prod(lattice), math.prod(s + 2 for s in lattice)
    t = torch.full((24, V1), float("nan"), device=p_h.device)
    ap = torch.full((24, V), float("nan"), device=p_h.device)

    def run():
        wk.wilson_normal_interior_cuda(p_h, u_h, KAPPA, lattice, boxes[0], t, ap, vvl)
        wk.wilson_normal_boundary_cuda(p_h, u_h, KAPPA, lattice, boxes[0], boxes[1:], t, ap, vvl)

    n0 = (wk.WILSON_NORMAL_BOX_T.launches, wk.WILSON_NORMAL_BOX_AP.launches)
    run()
    torch.cuda.synchronize()
    if (wk.WILSON_NORMAL_BOX_T.launches - n0[0], wk.WILSON_NORMAL_BOX_AP.launches - n0[1]) != (2, 2):
        raise AssertionError("K5HO: a split is not two t and two ap launches")
    if bool(t.isnan().any()):
        raise AssertionError("K5HO: t not written on every ring-1 site")
    plain = wk.wilson_normal_split_plain(p_h, u_h, KAPPA, lattice, boxes[0], boxes[1:])
    err = field_err(ap, plain, "wilson_normal_box")
    exact_err(ap, whole, "K5HO's split against K5H")
    del plain

    def one(kern, ents, src, dst):
        tb, n = wk._table(ents)
        kern.launch(p_h.device, src.data_ptr(), u_h.data_ptr(), dst.data_ptr(), float(KAPPA),
                    *lattice, tb, n, vvl)

    tables = wk.split_tables(lattice, boxes[0], boxes[1:])
    parts = dict(tables)
    for i, (et_, ea) in enumerate(zip(tables["shell t"][1], tables["boundary ap"][1])):
        parts[f"shell t {i}"] = ("t", [et_])
        parts[f"boundary ap {i}"] = ("ap", [ea])
    part_rows = {}
    for name, (kind, ents) in parts.items():
        kern, src, dst = ((wk.WILSON_NORMAL_BOX_T, p_h, t) if kind == "t"
                          else (wk.WILSON_NORMAL_BOX_AP, t, ap))
        nb, ns = wk.table_footprint(lattice, kind, ents, p_h.device)
        part_rows[name] = dict(
            ms=time_ms(lambda: one(kern, ents, src, dst)), bound_ms=bound(nb, 0)[0],
            sector_bound_ms=bound(32 * ns, 0)[0],
            entries=[[list(a), list(b_), c, d] for a, b_, c, d in ents])
    exact_err(ap, whole, "K5HO's parts against K5H")
    turns = {"k5h": [], "split": []}
    for name in ("k5h", "split", "split", "k5h"):
        turns[name].append(time_ms(run if name == "split" else
                                   (lambda: wk.wilson_normal_pre_cuda(p_h, u_h, KAPPA, lattice,
                                                                      vvl))))
    # the split computes K5H's function (each t site once): K5H's bytes and
    # flops, and the p and u values its two phases both read
    reread = split_reread_bytes(lattice, tables, p_h.device)
    extra = dict(parts=part_rows, k5h_ms=turns["k5h"], split_ms_turns=turns["split"],
                 reread_bound_ms=bound(reread, 0)[0],
                 launches_a_split=4, boxes=[[list(o_), list(e_)] for o_, e_ in boxes],
                 split_ratio=statistics.median(turns["split"]) / statistics.median(turns["k5h"]))
    rows = {}
    add_row(rows, "wilson_normal_box", err, statistics.median(turns["split"]),
            time_ms(lambda: wk.wilson_normal_split_plain(p_h, u_h, KAPPA, lattice, boxes[0],
                                                         boxes[1:]), reps=3, warm=1),
            wilson_normal_pre_bytes(lattice) + reread, wilson_normal_pre_ops(lattice))
    log(f"  K5HO bitwise K5H; split {turns['split']} ms against K5H {turns['k5h']} (ratio "
        f"{extra['split_ratio']:.3f}); the phases' re-read {extra['reread_bound_ms']:.4f} ms; "
        f"parts (ms, bound, sector bound): "
        + ", ".join(f"{n} {r['ms']:.4f} {r['bound_ms']:.4f} {r['sector_bound_ms']:.4f}"
                    for n, r in part_rows.items()))
    del p_h, u_h, whole, t, ap
    torch.cuda.empty_cache()
    return rows, extra


def overlap_trace(cfg, u, b):
    """D2: a torch.profiler trace of "overlap" iterations' operator on the
    one-rank mesh (p filled, then ``overlap_launch``), the last of TRACE_RUNS
    read (a profiler session may drop its first kernels): the interior box's
    kernels and the exchange's copies (the kernels on the other stream),
    their intervals, streams, and the ms during which both ran.  A trace
    with no box kernel is recorded as not measured."""
    from torch.profiler import ProfilerActivity, profile

    dom = make_domain(cfg, one_rank_mesh(D_MILC_AXES), D_MILC_AXES)
    ul, bl = dom.scatter(u.canonical_nd()), dom.scatter(b.canonical_nd())
    dec, mesh = dom.decomposed, dom.mesh
    nk = D2_OVERLAP_KERNELS
    graph = cg_mod.wilson_normal_graph(KAPPA)
    u_h = exchange_padded(ul, dec, width=2, mesh=mesh)
    uF = Field.from_canonical("u", u_h, tuple(u_h.shape[1:]))

    def one():
        p_h = fill_padded(bl, dec, width=2)
        return overlap_launch(graph, {"p": Field.from_canonical("p", p_h, tuple(p_h.shape[1:])),
                                      "u": uF}, decomposed=dec, config=cfg.target,
                              outputs=("ap",), halo="overlap", exchanged=("u",), mesh=mesh)

    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_RUNS):
            one()
            torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="overlap_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset") and "stream" in e.get("args", {})]
    dev.sort(key=lambda e: e["ts"])
    boxk = [e for e in dev if "wilson_normal_box" in e["name"]]
    if len(boxk) < nk:
        log(f"D2 trace: {len(dev)} device events, {len(boxk)} box kernels of the last run's "
            f"{nk}: the overlap is not measured")
        del ul, bl, u_h, uF
        torch.cuda.empty_cache()
        return dict(measured=False, device_events=len(dev), box_kernels=len(boxk))
    # the last run: its nk box kernels, and what ran after the run before
    last = boxk[-nk:]
    since = boxk[-nk - 1]["ts"] + boxk[-nk - 1]["dur"] if len(boxk) > nk else 0
    main = last[0]["args"]["stream"]
    interior = last[:2]   # the interior's t and ap launches come first
    side = [e for e in dev if e["args"]["stream"] != main and e["ts"] >= since]

    def hull(es):
        return (min(e["ts"] for e in es), max(e["ts"] + e["dur"] for e in es))

    ti = hull(interior)
    out = dict(measured=True, device_events=len(dev), main_stream=main,
               interior_kernels=[e["name"][:60] for e in interior],
               interior_us=[ti[0], ti[1]], interior_ms=(ti[1] - ti[0]) / 1e3)
    if side:
        ts = hull(side)
        both = max(0.0, min(ti[1], ts[1]) - max(ti[0], ts[0]))
        out.update(exchange_streams=sorted({e["args"]["stream"] for e in side}),
                   exchange_events=len(side), exchange_us=[ts[0], ts[1]],
                   exchange_ms=(ts[1] - ts[0]) / 1e3,
                   exchange_busy_ms=sum(e["dur"] for e in side) / 1e3, both_ms=both / 1e3)
    else:
        out.update(exchange_streams=[], exchange_events=0, both_ms=0.0)
    log(f"D2 trace of an overlap iteration's operator: {out}")
    del ul, bl, u_h, uF
    torch.cuda.empty_cache()
    return out


def halo_paths(dom, x):
    """D2: the sharded solve's halo'd spinor (``exchange_padded``: one copy
    into the halo'd array, then the exchange) against the JAX package's
    ``exchange(halo_pad(x))`` (a wrap-pad a site dim, then the exchange),
    at widths 1 (None's dslash) and 2 ("pre"'s p): bitwise, and timed."""
    dec, mesh, dims = dom.decomposed, dom.mesh, range(1, x.dim())
    out = {}
    for w in (1, 2):
        def one():
            return exchange_padded(x, dec, width=w, mesh=mesh)

        def two():
            return exchange(halo_pad(x, w, dims), dec, width=w, mesh=mesh)

        exact_err(one(), two(), f"exchange_padded width {w}")
        out[w] = dict(exchange_padded=time_ms(one), pad_then_exchange=time_ms(two))
        log(f"D2 the spinor's halo at width {w}: exchange_padded "
            f"{out[w]['exchange_padded']:.4f} ms, exchange(halo_pad) "
            f"{out[w]['pad_then_exchange']:.4f} ms (bitwise)")
    torch.cuda.empty_cache()
    return out


def sharded_milc(cfg, u, b, x_soa, iterations, solve_s):
    """D2: the one-rank sharded solves, counted; "overlap" also against
    "pre" (iterations, x bitwise) and traced."""
    dom = make_domain(cfg, one_rank_mesh(D_MILC_AXES), D_MILC_AXES)
    ul, bl = dom.scatter(u.canonical_nd()), dom.scatter(b.canonical_nd())
    x_ref = x_soa.reshape((24,) + tuple(cfg.lattice))
    out, counts = {"halo_ms": halo_paths(dom, bl)}, {}
    x_pre = None
    for halo in (None, "pre", "overlap"):
        solver = make_sharded_solver(cfg, dom, halo)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, it, res = solver(ul, bl)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts[halo] = path_counts(D2_PATHS[halo])
        whole = path_counts(D2_NOT_OVERLAP)
        rel = (torch.linalg.norm(x - x_ref) / torch.linalg.norm(x_ref)).item()
        log(f"D2 sharded solve {cfg.lattice}, halo={halo!r}, one rank: {it} iterations (phase 4: "
            f"{iterations}), {sec:.3f} s, {sec / max(it, 1) * 1e3:.3f} ms/iter (phase 4 "
            f"{solve_s / iterations * 1e3:.3f}), x rel-L2 {rel:.3e} from phase 4's, residual "
            f"{float(res):.3e}; launches {counts[halo]}")
        if not torch.isfinite(x).all():
            raise AssertionError(f"D2 halo={halo!r}: non-finite x")
        if abs(it - iterations) > 1 or not rel < D_REL_X:
            raise AssertionError(f"D2 halo={halo!r}: {it} iterations, x rel-L2 {rel}")
        idle = [n for n, c in counts[halo].items() if c == 0]
        if idle:
            raise AssertionError(f"D2 halo={halo!r}: kernels of the path never launched: {idle}")
        out[str(halo)] = dict(iterations=it, seconds=sec, ms_per_iteration=sec / it * 1e3,
                              x_rel_l2=rel, residual=float(res))
        if halo == "pre":
            x_pre, it_pre = x, it
        if halo == "overlap":
            # the split's boxes, never the whole launch, four kernels an
            # operator; "pre"'s trajectory
            if any(whole.values()):
                raise AssertionError(f"D2 overlap: the whole 'pre' kernels ran: {whole}")
            nk = counts[halo]["wilson_normal_box"]
            if nk > D2_OVERLAP_KERNELS * it:
                raise AssertionError(f"D2 overlap: {nk} K5HO launches in {it} iterations, more "
                                     f"than {D2_OVERLAP_KERNELS} an operator")
            out["overlap"]["k5ho_launches"] = nk
            if it != it_pre or not torch.equal(x, x_pre):
                raise AssertionError(f"D2 overlap: {it} iterations against 'pre''s {it_pre}, "
                                     f"x bitwise {torch.equal(x, x_pre)}")
            out["overlap"]["bitwise_pre"] = True
            log(f"D2 overlap: 'pre''s {it_pre} iterations and x bitwise; "
                f"{out['overlap']['ms_per_iteration']:.3f} ms/iter against 'pre' "
                f"{out['pre']['ms_per_iteration']:.3f} and phase 4 "
                f"{solve_s / iterations * 1e3:.3f}")
        del x, solver
        torch.cuda.empty_cache()
    # the sharded plans: the budget tiles the operator's "pre" launch
    # (K5TH); "overlap" takes the reference's untiled default
    bcfg = dataclasses.replace(cfg, target=dataclasses.replace(cfg.target,
                                                               smem_bytes=SMEM_BUDGET))
    for name, c, halo, path, forbidden in (
            ("pre_budget", bcfg, "pre", {**D2_PATHS["pre"], **D2_PRE_TILED},
             {"wilson_normal_pre": DECOMP_PATH["wilson_normal_pre"]}),
            ("overlap_budget", bcfg, "overlap", D2_PATHS["overlap"], D2_NOT_OVERLAP)):
        solver = make_sharded_solver(c, dom, halo)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, it, res = solver(ul, bl)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts[name] = {n: v for n, v in path_counts(path).items() if n not in forbidden}
        whole = path_counts(forbidden)
        log(f"D2 sharded solve {cfg.lattice}, {name}, one rank: {it} iterations, "
            f"{sec / max(it, 1) * 1e3:.3f} ms/iter ('pre' {out['pre']['ms_per_iteration']:.3f}); "
            f"launches {counts[name]}, not {whole}")
        idle = [n for n, v in counts[name].items() if v == 0]
        if idle or any(whole.values()):
            raise AssertionError(f"D2 {name}: idle {idle}, forbidden kernels ran {whole}")
        if it != it_pre or not torch.equal(x, x_pre):
            raise AssertionError(f"D2 {name}: {it} iterations against 'pre''s {it_pre}, "
                                 f"x bitwise {torch.equal(x, x_pre)}")
        out[name] = dict(iterations=it, seconds=sec, ms_per_iteration=sec / it * 1e3,
                         bitwise_pre=True)
        del x, solver
        torch.cuda.empty_cache()
    # tiled K5HO through the operator's entry point: overlap_launch under an
    # explicit tiled plan, D_OPERATORS times on p filled afresh, bitwise its
    # "pre" launch.  No driver path runs tiled K5HO: the solver's default
    # overlap plan is the reference's untiled one, and an explicit tiled
    # plan_policy would also tile the solve's site-local launches, which
    # refuse a tile (core.plan.adapt_plan)
    dec, hl = dom.decomposed, tuple(s_ + 4 for s_ in cfg.lattice)
    normal = cg_mod.wilson_normal_graph(float(cfg.kappa))
    uF = Field.from_canonical("u", exchange_padded(ul, dec, width=2, mesh=dom.mesh), hl)

    def operator(halo, op_plan=None):
        pF = Field.from_canonical("p", fill_padded(x_pre, dec, width=2), hl)
        return overlap_launch(normal, {"p": pF, "u": uF}, decomposed=dec, config=cfg.target,
                              outputs=("ap",), halo=halo, exchanged=("u",), plan=op_plan,
                              mesh=dom.mesh)["ap"].data

    want = operator("pre")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(D_OPERATORS):
        got = operator("overlap", K5HO_OUTER)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts["tiled_overlap"] = path_counts(D2_BOX_TILED)
    log(f"D2 {D_OPERATORS} operators under {K5HO_OUTER.describe()}: "
        f"{sec / D_OPERATORS * 1e3:.3f} ms an operator, launches {counts['tiled_overlap']}")
    exact_err(got, want, "D2 tiled overlap operator against 'pre'")
    if counts["tiled_overlap"]["wilson_normal_box_tiled"] != 2 * D_OPERATORS:
        raise AssertionError(f"D2 tiled overlap: {counts['tiled_overlap']} tiled K5HO launches, "
                             f"not two an operator")
    out["tiled_overlap_operator"] = dict(plan=K5HO_OUTER.describe(), operators=D_OPERATORS,
                                         ms_per_operator=sec / D_OPERATORS * 1e3,
                                         bitwise_pre=True)
    del uF, got, want
    del x_pre
    out["phase4_ms_per_iteration"] = solve_s / iterations * 1e3
    torch.cuda.empty_cache()
    return out, counts


def check_halo_ludwig(state, cfg, vvl):
    """D1 (Ludwig): K8H (one call through ``propagate_halo``, counted) and
    K5LH at the step's lattice, on L2's kind of inputs wrap-padded."""
    lat, tau = tuple(cfg.lattice), cfg.tau
    V, Vh = math.prod(lat), math.prod(s + 2 for s in lat)
    dev = state.dist.data.device
    gen = torch.Generator(device=dev).manual_seed(4)
    dist = state.dist.canonical() * (1.0 + 0.05 * torch.randn((19, V), generator=gen, device=dev))
    force = 1e-3 * torch.randn((3, V), generator=gen, device=dev)
    dh = wrap_pad(dist.reshape((19,) + lat), 1)
    rows = {}
    reset_counts()
    got = propagate_halo(dh, config=cfg.target, width=1)
    pcounts = path_counts({"lb_propagate_halo": DECOMP_PATH["lb_propagate_halo"]})
    err = exact_err(got, k8.propagate_halo_plain(dh, 1), "lb_propagate_halo")
    exact_err(got.reshape(19, -1), k8.propagate_cuda(dist, lat, vvl), "K8H against K8")
    # torch.take on the 19 source offsets of each output in the halo'd array
    cv = torch.from_numpy(d3q19.CV.astype("int64")).to(dev)
    s_ = torch.arange(V, device=dev)
    z, y, x = s_ % lat[2], s_ // lat[2] % lat[1], s_ // (lat[1] * lat[2])
    del s_
    idx = torch.stack([i * Vh + ((x + 1 - cv[i, 0]) * (lat[1] + 2) + (y + 1 - cv[i, 1]))
                       * (lat[2] + 2) + (z + 1 - cv[i, 2]) for i in range(19)])
    del x, y, z
    exact_err(torch.take(dh, idx), got.reshape(19, -1), "torch.take against lb_propagate_halo")
    add_row(rows, "lb_propagate_halo", err, time_ms(lambda: k8.propagate_halo_cuda(dh, 1, vvl)),
            time_ms(lambda: k8.propagate_halo_plain(dh, 1), reps=3, warm=1),
            # velocity i reads an interior-sized window: K8's traffic
            19 * 4 * 2 * V, 0, library_ms=time_ms(lambda: torch.take(dh, idx)))
    del idx, got
    dh2 = wrap_pad(dist.reshape((19,) + lat), 2)
    exact_err(k8.propagate_halo_cuda(dh2, 2, vvl), k8.propagate_halo_plain(dh2, 2),
              "lb_propagate_halo width 2")
    log("  K8H at width 2 bitwise its plain version")
    del dh2
    fh = wrap_pad(force.reshape((3,) + lat), 1).reshape(3, -1)
    dh = dh.reshape(19, -1)
    got = k8.lb_step_pre_cuda(dh, fh, tau, lat, vvl)
    want = k8.lb_step_pre_plain(dh, fh, tau, lat)
    err = max(exact_err(got[0], want[0], "lb_step_pre dist2"),
              exact_err(got[1], want[1], "lb_step_pre u"))
    per = k8.lb_step_cuda(dist, force, tau, lat, vvl)
    exact_err(got[0], per[0], "K5LH dist2 against K5L")
    exact_err(got[1], per[1], "K5LH u against K5L")
    log(f"  K5LH bitwise K5L's periodic launch; K5L "
        f"{time_ms(lambda: k8.lb_step_cuda(dist, force, tau, lat, vvl)):.4f} ms")
    add_row(rows, "lb_step_pre", err, time_ms(lambda: k8.lb_step_pre_cuda(dh, fh, tau, lat, vvl)),
            time_ms(lambda: k8.lb_step_pre_plain(dh, fh, tau, lat), reps=3, warm=1),
            lb_step_pre_bytes(lat), FLOPS["lb_step"] * lb_step_pre_sites(lat))
    del dist, force, dh, fh, got, want, per
    torch.cuda.empty_cache()
    return rows, pcounts


def check_box_ludwig(state, cfg, vvl):
    """D1 (Ludwig): K5LHO on each box of the full lattice's overlap split
    (ring 1, every dim decomposed: the interior and 6 slabs), on L2's kind
    of inputs wrap-padded: each box bitwise its plain version and K5LH's
    sites there, the assembled dist2 and u bitwise K5LH's; the interior box
    and the slabs together timed beside the bytes each box depends on
    (counted as K5LH's are)."""
    lat, tau = tuple(cfg.lattice), cfg.tau
    V = math.prod(lat)
    dev = state.dist.data.device
    gen = torch.Generator(device=dev).manual_seed(5)
    dist = state.dist.canonical() * (1.0 + 0.05 * torch.randn((19, V), generator=gen, device=dev))
    force = 1e-3 * torch.randn((3, V), generator=gen, device=dev)
    dh = wrap_pad(dist.reshape((19,) + lat), 1).reshape(19, -1)
    fh = wrap_pad(force.reshape((3,) + lat), 1).reshape(3, -1)
    del dist, force
    w2, wu = k8.lb_step_pre_cuda(dh, fh, tau, lat, vvl)
    boxes = split_of(lat, 1)
    d2 = torch.full((19, V), float("nan"), device=dev)
    u = torch.full((3, V), float("nan"), device=dev)
    for o, e in boxes:
        k8.lb_step_box_cuda(dh, fh, tau, lat, o, e, d2, u, vvl)
        pd, pu = k8.lb_step_box_plain(dh, fh, tau, lat, o, e)
        for got, want, full, n in ((d2, pd, w2, "dist2"), (u, pu, wu, "u")):
            g = got.reshape((got.shape[0],) + lat)[box_sl(o, e)]
            exact_err(g.reshape(got.shape[0], -1), want, f"lb_step_box {n} {o} {e}")
            exact_err(g, full.reshape((got.shape[0],) + lat)[box_sl(o, e)],
                      f"K5LHO {n} box {o} {e} against K5LH")
    exact_err(d2, w2, "K5LHO dist2 assembled against K5LH")
    exact_err(u, wu, "K5LHO u assembled against K5LH")

    def run(bs):
        for o, e in bs:
            k8.lb_step_box_cuda(dh, fh, tau, lat, o, e, d2, u, vvl)

    def plain():
        for o, e in boxes:
            k8.lb_step_box_plain(dh, fh, tau, lat, o, e)

    # each box's bytes counted as K5LH's are on the whole interior
    nb = [lb_step_pre_bytes(e) for _, e in boxes]
    extra = dict(interior_ms=time_ms(lambda: run(boxes[:1])),
                 slabs_ms=time_ms(lambda: run(boxes[1:])),
                 interior_bound_ms=bound(nb[0], 0)[0], slabs_bound_ms=bound(sum(nb[1:]), 0)[0],
                 k5lh_ms=time_ms(lambda: k8.lb_step_pre_cuda(dh, fh, tau, lat, vvl)),
                 boxes=[[list(o), list(e)] for o, e in boxes],
                 box_ms=[time_ms(lambda bx=bx: run([bx])) for bx in boxes],
                 box_bound_ms=[bound(n, 0)[0] for n in nb])
    rows = {}
    add_row(rows, "lb_step_box", 0.0, time_ms(lambda: run(boxes)),
            time_ms(plain, reps=3, warm=1), sum(nb),
            FLOPS["lb_step"] * sum(lb_step_pre_sites(e) for _, e in boxes))
    log(f"  K5LHO bitwise its plain version and K5LH on every box and assembled; interior "
        f"{boxes[0][1]} {extra['interior_ms']:.4f} ms (bound {extra['interior_bound_ms']:.4f}), "
        f"{len(boxes) - 1} slabs {extra['slabs_ms']:.4f} ms (bound "
        f"{extra['slabs_bound_ms']:.4f}), K5LH {extra['k5lh_ms']:.4f} ms; a box: "
        + ", ".join(f"{e} {ms:.4f}" for (_, e), ms in zip(boxes, extra["box_ms"])))
    del dh, fh, w2, wu, d2, u
    torch.cuda.empty_cache()
    return rows, extra


def budget_pre_tile(lattice, in_views, out_views):
    """The tile of a "pre" launch's default plan at ``lattice`` under the
    227 KiB budget, from its footprint descriptor."""
    p = plan.default_plan(TargetConfig("cuda", device="cuda", smem_bytes=SMEM_BUDGET),
                          nsites=math.prod(lattice), layouts=[SOA], stencil=True,
                          lattice=lattice, smem_views=(in_views, out_views), bounded=True,
                          halo="pre")
    if not p.tiled:
        raise AssertionError(f"the 227 KiB budget does not tile the 'pre' launch at {lattice}")
    return (p.bx, p.by, p.bz)


def in_turns(fns, reps=10):
    """Each fn timed (time_ms) in the order a, b, b, a: name -> [ms, ms]."""
    out = {n: [] for n in fns}
    names = list(fns)
    for n in names + names[::-1]:
        out[n].append(time_ms(fns[n], reps=reps))
    return out


def check_tiled_halo_milc(u, b, lattice, vvl):
    """D1 (MILC): K5TH at the budget's tile of the wilson_normal "pre"
    launch and at K5T_WALK_TILE, and tiled K5HO on the full split under
    K5HO_OUTER's sub-plan tiles: each bitwise K5H, within FIELD_RTOL of its
    plain version, timed in turns with K5H beside its bound (K5H's bytes;
    tiled K5HO K5HO's, with the re-read of its two phases)."""
    p_h = wrap_pad(b.canonical_nd(), 2).reshape(24, -1)
    u_h = wrap_pad(u.canonical_nd(), 2).reshape(72, -1)
    whole = wk.wilson_normal_pre_cuda(p_h, u_h, KAPPA, lattice, vvl)
    plain = wk.wilson_normal_pre_plain(p_h, u_h, KAPPA, lattice)
    plain_ms = time_ms(lambda: wk.wilson_normal_pre_plain(p_h, u_h, KAPPA, lattice), reps=3,
                       warm=1)
    tile = budget_pre_tile(lattice, ((24, 2, 4), (72, 2, 4)), ((24, 4),))
    rows, extra = {}, {"k5th": {}}
    errs = {}
    for name, tl in (("budget", tile), ("walk", K5T_WALK_TILE)):
        n0 = (wk.WILSON_NORMAL_PRE_T_TILED.launches, wk.WILSON_NORMAL_PRE_AP_TILED.launches)
        got = wk.wilson_normal_pre_cuda(p_h, u_h, KAPPA, lattice, vvl, tile=tl)
        if (wk.WILSON_NORMAL_PRE_T_TILED.launches - n0[0],
                wk.WILSON_NORMAL_PRE_AP_TILED.launches - n0[1]) != (1, 1):
            raise AssertionError("K5TH: not one t and one ap launch")
        exact_err(got, whole, f"K5TH at tile {tl} against K5H")
        errs[name] = field_err(got, plain, f"K5TH at tile {tl}")
        turns = in_turns({"k5h": lambda: wk.wilson_normal_pre_cuda(p_h, u_h, KAPPA, lattice, vvl),
                          "k5th": lambda tl=tl: wk.wilson_normal_pre_cuda(p_h, u_h, KAPPA,
                                                                         lattice, vvl, tile=tl)})
        extra["k5th"][name] = dict(tile=list(tl), ms_turns=turns["k5th"], k5h_ms=turns["k5h"])
        log(f"  K5TH at tile {tl} bitwise K5H: {turns['k5th']} ms against K5H {turns['k5h']}")
    add_row(rows, "wilson_normal_pre_tiled", errs["budget"],
            statistics.median(extra["k5th"]["budget"]["ms_turns"]), plain_ms,
            wilson_normal_pre_bytes(lattice), wilson_normal_pre_ops(lattice))
    del got

    boxes = split_of(lattice, 2)
    cfg = TargetConfig("cuda", device="cuda", vvl=vvl)
    tiles = [plan.plan_tile(plan.sub_lattice_plan(K5HO_OUTER, cfg, e)) for _, e in boxes]
    V, V1 = math.prod(lattice), math.prod(s + 2 for s in lattice)
    t = torch.full((24, V1), float("nan"), device=p_h.device)
    ap = torch.full((24, V), float("nan"), device=p_h.device)

    def run(tl):
        wk.wilson_normal_interior_cuda(p_h, u_h, KAPPA, lattice, boxes[0], t, ap, vvl,
                                       tile=tl[0])
        wk.wilson_normal_boundary_cuda(p_h, u_h, KAPPA, lattice, boxes[0], boxes[1:], t, ap,
                                       vvl, tiles=tl[1:])

    n0 = (wk.WILSON_NORMAL_BOX_T.launches, wk.WILSON_NORMAL_BOX_AP_TILED.launches)
    run(tiles)
    torch.cuda.synchronize()
    if (wk.WILSON_NORMAL_BOX_T.launches - n0[0],
            wk.WILSON_NORMAL_BOX_AP_TILED.launches - n0[1]) != (2, 2):
        raise AssertionError("tiled K5HO: a split is not two t and two tiled ap launches")
    if bool(t.isnan().any()):
        raise AssertionError("tiled K5HO: t not written on every ring-1 site")
    exact_err(ap, whole, "tiled K5HO's split against K5H")
    split_plain = wk.wilson_normal_split_plain(p_h, u_h, KAPPA, lattice, boxes[0], boxes[1:])
    err = field_err(ap, split_plain, "wilson_normal_box_tiled")
    del split_plain
    untiled = [None] * len(boxes)
    turns = in_turns({"k5h": lambda: wk.wilson_normal_pre_cuda(p_h, u_h, KAPPA, lattice, vvl),
                      "tiled_split": lambda: run(tiles), "split": lambda: run(untiled)})
    tables = wk.split_tables(lattice, boxes[0], boxes[1:])
    reread = split_reread_bytes(lattice, tables, p_h.device)
    add_row(rows, "wilson_normal_box_tiled", err, statistics.median(turns["tiled_split"]),
            time_ms(lambda: wk.wilson_normal_split_plain(p_h, u_h, KAPPA, lattice, boxes[0],
                                                         boxes[1:]), reps=3, warm=1),
            wilson_normal_pre_bytes(lattice) + reread, wilson_normal_pre_ops(lattice))
    extra["tiled_k5ho"] = dict(outer=K5HO_OUTER.describe(), tiles=[list(x) if x else None
                                                                  for x in tiles],
                               ms_turns={k: v for k, v in turns.items()})
    log(f"  tiled K5HO ({K5HO_OUTER.describe()}: tiles {tiles}) bitwise K5H; turns {turns}")
    del p_h, u_h, whole, plain, t, ap
    torch.cuda.empty_cache()
    return rows, extra


def check_tiled_halo_ludwig(state, cfg, vvl):
    """D1 (Ludwig): K9H at the budget's tile of the ludwig_lb_step "pre"
    launch with u and without (lb_collide_propagate), at K9H_COARSE_TILE
    against its tiled plain version, and untiled in aosoa4 (in place), on
    L2's kind of inputs wrap-padded: dist2 and u bitwise K5LH's (unpacked)
    and the plain version's, timed in turns with K5LH beside K5LH's bytes."""
    lat, tau = tuple(cfg.lattice), cfg.tau
    V = math.prod(lat)
    dev = state.dist.data.device
    gen = torch.Generator(device=dev).manual_seed(6)
    dist = state.dist.canonical() * (1.0 + 0.05 * torch.randn((19, V), generator=gen, device=dev))
    force = 1e-3 * torch.randn((3, V), generator=gen, device=dev)
    dh = wrap_pad(dist.reshape((19,) + lat), 1).reshape(19, -1)
    fh = wrap_pad(force.reshape((3,) + lat), 1).reshape(3, -1)
    del dist, force
    w2, wu = k8.lb_step_pre_cuda(dh, fh, tau, lat, vvl)
    pd, pu = k8.lb_step_pre_plain(dh, fh, tau, lat)
    exact_err(w2, pd, "K5LH dist2 against its plain version")
    plain_ms = time_ms(lambda: k8.lb_step_pre_plain(dh, fh, tau, lat), reps=3, warm=1)
    del pd, pu
    tile = budget_pre_tile(lat, ((19, 1, 4), (3, 1, 4)), ((19, 4), (3, 4)))
    rows, extra = {}, {}
    n0 = k8.LB_STEP_HALO.launches
    g2, gu = k8.lb_step_pre_cuda(dh, fh, tau, lat, vvl, tile=tile)
    c2, _ = k8.lb_step_pre_cuda(dh, fh, tau, lat, vvl, False, tile=tile)
    if k8.LB_STEP_HALO.launches - n0 != 2:
        raise AssertionError("K9H: not one launch a call")
    err = max(exact_err(g2, w2, "K9H dist2 at the budget's tile against K5LH"),
              exact_err(gu, wu, "K9H u at the budget's tile against K5LH"),
              exact_err(c2, w2, "K9H without u at the budget's tile against K5LH"))
    del g2, gu, c2
    coarse = tuple(e or n for e, n in zip(K9H_COARSE_TILE, lat))
    g2, gu = k8.lb_step_pre_cuda(dh, fh, tau, lat, vvl, tile=coarse)
    p2, pu = k8.lb_step_pre_plain(dh, fh, tau, lat, tile=coarse)
    exact_err(g2, p2, f"K9H dist2 at {coarse} against its tiled plain version")
    exact_err(gu, pu, f"K9H u at {coarse} against its tiled plain version")
    exact_err(g2, w2, f"K9H dist2 at {coarse} against K5LH")
    del g2, gu, p2, pu
    turns = in_turns({"k5lh": lambda: k8.lb_step_pre_cuda(dh, fh, tau, lat, vvl),
                      "k9h": lambda: k8.lb_step_pre_cuda(dh, fh, tau, lat, vvl, tile=tile),
                      "k9h_no_u": lambda: k8.lb_step_pre_cuda(dh, fh, tau, lat, vvl, False,
                                                              tile=tile)})
    add_row(rows, "lb_step_halo", err, statistics.median(turns["k9h"]), plain_ms,
            lb_step_pre_bytes(lat), FLOPS["lb_step"] * lb_step_pre_sites(lat))
    a4 = parse_layout("aosoa4")
    lays = {n: a4 for n in ("dist", "force", "dist2", "u")}
    da, fa = a4.pack(dh), a4.pack(fh)
    g2, gu = k8.lb_step_pre_cuda(da, fa, tau, lat, vvl, layouts=lays)
    err4 = max(exact_err(a4.unpack(g2), w2, "K9H dist2 in aosoa4 against K5LH"),
               exact_err(a4.unpack(gu), wu, "K9H u in aosoa4 against K5LH"))
    p2, pu = k8.lb_step_pre_plain(da, fa, tau, lat, layouts=lays)
    exact_err(g2, p2, "K9H dist2 in aosoa4 against its plain version")
    del g2, gu, p2, pu
    t4 = in_turns({"k5lh": lambda: k8.lb_step_pre_cuda(dh, fh, tau, lat, vvl),
                   "k9h_aosoa4": lambda: k8.lb_step_pre_cuda(da, fa, tau, lat, vvl,
                                                             layouts=lays)})
    add_row(rows, "lb_step_halo@aosoa4", err4, statistics.median(t4["k9h_aosoa4"]),
            time_ms(lambda: k8.lb_step_pre_plain(da, fa, tau, lat, layouts=lays), reps=3,
                    warm=1),
            lb_step_pre_bytes(lat), FLOPS["lb_step"] * lb_step_pre_sites(lat))
    # lb_collide_propagate: dist2 alone, 19 values written a site
    nb_no_u = 22 * 4 * lb_step_pre_sites(lat) + 19 * 4 * V
    extra = dict(tile=list(tile), coarse_tile=list(coarse), ms_turns=turns,
                 aosoa4_ms_turns=t4, no_u_bound_ms=bound(nb_no_u, 0)[0])
    log(f"  K9H at the budget's tile {tile} and {coarse}, with and without u, and in aosoa4 "
        f"bitwise K5LH and its plain versions; turns {turns}, aosoa4 {t4}; without u beside "
        f"{extra['no_u_bound_ms']:.4f} ms")
    del dh, fh, da, fa, w2, wu
    torch.cuda.empty_cache()
    return rows, extra


def sharded_ludwig(state, cfg):
    """D3: D_STEPS one-rank sharded steps from the L1 state, counted,
    against as many single-device steps."""
    dom = Domain(tuple(cfg.lattice), one_rank_mesh(D_LUDWIG_AXES), D_LUDWIG_AXES, halo=2)
    sstep = ludwig.make_sharded_step(cfg, dom)
    s = state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(D_STEPS):
        s = step(s, cfg)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) / D_STEPS * 1e3
    d, q = dom.scatter(state.dist.canonical_nd()), dom.scatter(state.q.canonical_nd())
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(D_STEPS):
        d, q = sstep(d, q)
    torch.cuda.synchronize()
    sharded_ms = (time.perf_counter() - t0) / D_STEPS * 1e3
    counts = path_counts(D3_PATH)
    bits = {n: torch.equal(a, b_) for n, a, b_ in (("dist", d, s.dist.canonical_nd()),
                                                  ("q", q, s.q.canonical_nd()))}
    diffs = {n: (a - b_).abs().max().item() for n, a, b_ in (("dist", d, s.dist.canonical_nd()),
                                                            ("q", q, s.q.canonical_nd()))}
    log(f"D3 {D_STEPS} sharded steps {cfg.lattice}, one rank: {sharded_ms:.3f} ms/step against "
        f"{single_ms:.3f} single; bitwise {bits}, max abs diff {diffs}; launches {counts}")
    for n, a, b_ in (("dist", d, s.dist.canonical_nd()), ("q", q, s.q.canonical_nd())):
        if not torch.isfinite(a).all():
            raise AssertionError(f"D3: non-finite {n}")
        if not bits[n] and not torch.allclose(a, b_, rtol=D_STEP_RTOL, atol=D_STEP_ATOL):
            raise AssertionError(f"D3: sharded {n} differs from the single steps by {diffs[n]}")
    idle = [n for n, c in counts.items() if c == 0]
    if idle:
        raise AssertionError(f"D3: kernels of the sharded step never launched: {idle}")
    # the LB half-step under "overlap": the split's boxes, the exchange of
    # dist and force beside the interior box; bitwise the "pre" steps
    ostep = ludwig.make_sharded_step(cfg, dom, "overlap")
    od, oq = dom.scatter(state.dist.canonical_nd()), dom.scatter(state.q.canonical_nd())
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(D_STEPS):
        od, oq = ostep(od, oq)
    torch.cuda.synchronize()
    overlap_ms = (time.perf_counter() - t0) / D_STEPS * 1e3
    ocounts = path_counts(D3_OVERLAP_PATH)
    whole = path_counts(D3_NOT_OVERLAP)
    obits = {"dist": torch.equal(od, d), "q": torch.equal(oq, q)}
    log(f"D3 {D_STEPS} overlap steps {cfg.lattice}, one rank: {overlap_ms:.3f} ms/step against "
        f"'pre' {sharded_ms:.3f} and single {single_ms:.3f}; bitwise 'pre' {obits}; launches "
        f"{ocounts}")
    if not all(obits.values()) or not all(bits.values()):
        raise AssertionError(f"D3 overlap: not bitwise the 'pre' steps {obits} and the single "
                             f"steps {bits}")
    if any(whole.values()) or not all(ocounts.values()):
        raise AssertionError(f"D3 overlap: whole 'pre' kernels {whole}, path {ocounts}")
    counts.update(ocounts)
    del od, oq
    # the sharded plans: the 227 KiB budget tiles the LB half-step's "pre"
    # launch (K9H, never K5LH); aosoa4 under an explicit view="block" plan
    # runs K9H on AoSoA in place under "pre" and on the split's boxes
    plans = {}
    acfg = dataclasses.replace(cfg, layout=parse_layout("aosoa4"), target=dataclasses.replace(
        cfg.target, plan_policy=D3_BLOCK_PLAN))
    for name, c, halo in (
            ("budget", dataclasses.replace(cfg, target=dataclasses.replace(
                cfg.target, smem_bytes=SMEM_BUDGET)), "pre"),
            ("aosoa4_block", acfg, "pre"), ("aosoa4_block_overlap", acfg, "overlap")):
        pstep = ludwig.make_sharded_step(c, dom, halo)
        pd_, pq = dom.scatter(state.dist.canonical_nd()), dom.scatter(state.q.canonical_nd())
        # one untimed step: a layout's first step pays its first launches
        # and allocations (the cold aosoa4 "pre" steps read 117 ms a step
        # against 49 warm on an H100 80GB HBM3 at 700 W)
        pstep(pd_, pq)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(D_STEPS):
            pd_, pq = pstep(pd_, pq)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / D_STEPS * 1e3
        pc = path_counts(D3_TILED)
        whole = path_counts({**D3_NOT_OVERLAP, "lb_step_box": DECOMP_PATH["lb_step_box"]})
        pbits = {"dist": torch.equal(pd_, d), "q": torch.equal(pq, q)}
        log(f"D3 {D_STEPS} steps {cfg.lattice}, {name}: {ms:.3f} ms/step against 'pre' "
            f"{sharded_ms:.3f}; bitwise the SoA 'pre' steps {pbits}; K9H launches "
            f"{pc['lb_step_halo']}, K5LH and K5LHO {whole}")
        if not all(pbits.values()) or any(whole.values()) or not pc["lb_step_halo"]:
            raise AssertionError(f"D3 {name}: bitwise {pbits}, K9H {pc}, K5LH/K5LHO {whole}")
        plans[name] = dict(ms_per_step=ms, bitwise_pre=pbits, k9h_launches=pc["lb_step_halo"])
        row = {"budget": "lb_step_halo", "aosoa4_block": "lb_step_halo@aosoa4"}.get(name)
        if row:
            counts[row] = pc["lb_step_halo"]
        del pd_, pq, pstep
        torch.cuda.empty_cache()
    del d, q, s
    torch.cuda.empty_cache()
    return dict(steps=D_STEPS, ms_per_step=sharded_ms, single_ms_per_step=single_ms,
                bitwise=bits, max_abs_diff=diffs, overlap_ms_per_step=overlap_ms,
                overlap_bitwise_pre=obits, plans=plans), counts


def table_rows(path, counts, rows):
    return [dict(name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
                 replaces=rep, launches=counts[name], **rows[name])
            for name, (_, src, rep) in path.items()]


def layout_table_rows(path, counts, rows):
    """The kernel table's rows of the layout instances: one per kernel of
    ``path`` and layout other than SoA, named kernel@layout, with Y2's or
    Y3's launches and Y1's measurements in that layout."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return [dict(name=f"{name}@{lay}", route="cuda", source=f"src/repro_torch/csrc/{src}",
                 replaces=rep, launches=counts[lay][name], **{k: rows[lay][name][k] for k in keys})
            for lay in LAYOUT_SPECS[1:] for name, (_, src, rep) in path.items()]


def solve_timed(cfg, u, b):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(cfg, u, b)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lattice", type=int, nargs=4, default=[64, 64, 64, 32])
    ap.add_argument("--small", type=int, nargs=4, default=[16, 16, 16, 16])
    ap.add_argument("--ludwig", type=int, nargs=3, default=[256, 256, 256])
    ap.add_argument("--ludwig-small", type=int, nargs=3, default=[32, 32, 32])
    ap.add_argument("--seed", type=int, default=0, help="seed of S2 and S3's sources")
    args = ap.parse_args()
    lattice, small = tuple(args.lattice), tuple(args.small)

    # 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; no card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build the kernels while the host generates the problem
    cfg = MilcConfig(lattice=lattice, kappa=KAPPA, tol=TOL, hot=HOT, max_iter=MAX_ITER,
                     target=TargetConfig("cuda", device="cuda"))
    vvl = cfg.target.vvl
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        built = pool.submit(lambda: (_cuda.build(), time.perf_counter() - t0))
        flash_tools = pool.submit(flash_toolchain)
        u, b = init_problem(cfg, seed=0)
        gen_s = time.perf_counter() - t0
        lib, build_s = built.result()
        ptxas, parent_libs = flash_tools.result()
    _cuda.library()
    log(f"build: {build_s:.1f} s ({lib.name}); problem {lattice} generated and "
        f"uploaded in {gen_s:.1f} s")
    kern = spill = ""
    for ln in ptxas["k4_k5l"] + ptxas["k5t_k3c"]:   # a line a kernel: registers, spills
        if ln.startswith("Compiling entry"):
            kern = ln.split("'")[1] if "'" in ln else ln
        elif "spill" in ln:
            spill = ln
        elif ln.startswith("Used"):
            log(f"ptxas {kern}: {ln}; {spill}")

    # 3. every kernel against its plain version
    log(f"kernels at {lattice}, vvl {vvl} (V = {math.prod(lattice)}):")
    rows = check_kernels(u, b, lattice, vvl)
    # Q1. K1 and K2 in turns with the parent's design, where its tree is unpacked
    parent = ParentK12(parent_libs["k1_k2"], vvl) if "k1_k2" in parent_libs else None
    turns = milc_turns(parent, b, vvl) if parent else {}
    if not parent:
        log(f"Q1, Q2: no parent tree under {PARENT_SRC}; the parent's K1 and K2 are not timed")
    # Q3. K3 and K5 in turns with the parent's design
    if "k3_k5" in parent_libs:
        turns.update(k3_k5_turns(K35(ctypes.CDLL(str(parent_libs["k3_k5"])), "parent"),
                                 u, b, lattice, vvl))
    else:
        log(f"Q3: no parent tree under {PARENT_SRC}; the parent's K3 and K5 are not timed")

    # 4. the main path, counted
    reset_counts()
    res, solve_s = solve_timed(cfg, u, b)
    rc = residual_check(cfg, u, b, res.x)
    counts = path_counts(PATH)
    log(f"solve {lattice} on cuda: {res.iterations} iterations, {solve_s:.3f} s, "
        f"{solve_s / max(res.iterations, 1) * 1e3:.3f} ms/iter, residual "
        f"{float(res.residual):.3e}, |Mx-b|/|b| = {rc:.3e}")
    log(f"launches on the path: {counts}")
    if not torch.isfinite(res.x.data).all():
        raise AssertionError("solution has non-finite values")
    if not rc < 1e-3:
        raise AssertionError(f"residual_check {rc} >= 1e-3")
    idle = [n for n, c in counts.items() if c == 0]
    if idle:
        raise AssertionError(f"kernels of the path never launched: {idle}")
    if res.iterations >= MAX_ITER:
        raise AssertionError("CG did not converge")
    # u, b and x stay for Y1-Y2
    x_soa, iterations = res.x.data, res.iterations
    del res
    torch.cuda.empty_cache()

    # 5. the cuda engine against the torch engine, both on the card
    scfg = MilcConfig(lattice=small, kappa=KAPPA, tol=TOL, hot=HOT, max_iter=MAX_ITER,
                      target=TargetConfig("cuda", device="cuda"))
    tcfg = MilcConfig(lattice=small, kappa=KAPPA, tol=TOL, hot=HOT, max_iter=MAX_ITER,
                      target=TargetConfig("torch", device="cuda"))
    su, sb = init_problem(scfg, seed=0)
    rc_, t_c = solve_timed(scfg, su, sb)
    rt_, t_t = solve_timed(tcfg, su, sb)
    rel = (torch.linalg.norm(rc_.x.data - rt_.x.data) / torch.linalg.norm(rt_.x.data)).item()
    log(f"solve {small}: cuda {rc_.iterations} it ({t_c:.3f} s), torch {rt_.iterations} it "
        f"({t_t:.3f} s), x rel-L2 {rel:.3e}")
    if abs(rc_.iterations - rt_.iterations) > 1 or not rel < 1e-4:
        raise AssertionError("cuda and torch engines disagree")
    # su stays for S3
    del sb, rc_, rt_
    torch.cuda.empty_cache()

    # D1 (MILC). K4H and K5H against their plain versions; D2. the sharded solves
    t0 = time.perf_counter()
    log(f"D1: K4H and K5H at {lattice}, vvl {vvl}:")
    drows, k5h_floor = check_halo_milc(u, b, lattice, vvl)
    log(f"D1: K5HO on the overlap split of {lattice}, vvl {vvl}:")
    brows_o, box_milc = check_box_milc(u, b, lattice, vvl)
    drows.update(brows_o)
    log(f"D1: K5TH and tiled K5HO at {lattice}, vvl {vvl}:")
    trows_d, tiled_milc = check_tiled_halo_milc(u, b, lattice, vvl)
    drows.update(trows_d)
    d2, d2counts = sharded_milc(cfg, u, b, x_soa, iterations, solve_s)
    d2["wilson_normal_pre_design_floor_ms"] = k5h_floor
    d2["k5ho_split"] = box_milc
    d2["sharded_plans"] = tiled_milc
    log(f"D1 (MILC), D2: {time.perf_counter() - t0:.1f} s")

    # S1. the batch instances against their plain versions and single launches
    t0 = time.perf_counter()
    brows = check_batch_kernels(u, lattice, vvl)
    # S2. solve_batched, counted
    bs, dedicated, scounts, s_ms_it, s_solve_s, s_peak = serve_solve(cfg, u, args.seed)
    # S3. a SolveServer drain of mixed shapes
    drain = serve_drain(cfg, u, su, small, bs, dedicated, args.seed)
    serve_line = {"serving": {
        "card": smi, "slots": SLOTS, "lattice": list(lattice), "small": list(small),
        "solve_batched_s": s_solve_s, "ms_per_batched_iteration_loop": s_ms_it,
        "peak_gib": s_peak / 2**30, "ms_per_iteration_single": solve_s / iterations * 1e3,
        "dedicated_s": [d[1] for d in dedicated], **drain}}
    del bs, dedicated
    torch.cuda.empty_cache()
    log(f"S1-S3: {time.perf_counter() - t0:.1f} s")

    # P1. the policy instances against their plain versions, at the MILC lattice
    t0 = time.perf_counter()
    log(f"P1: the policy instances at {lattice}, vvl {vvl}:")
    mrows, mextra = check_mixed_milc(u, b, lattice, vvl)
    # P2. the refined solve, counted
    p2, p2counts, x_p2 = mixed_solve(cfg, u, b, x_soa, iterations, solve_s)
    # P3. refined serving at --small, counted
    p3, p3counts = mixed_serving(su, small, args.seed)
    del su
    torch.cuda.empty_cache()
    log(f"P1-P3: {time.perf_counter() - t0:.1f} s")
    # U1. the flat chains' policy instances, at the MILC lattice
    t0 = time.perf_counter()
    log(f"U1: K3's policy instance at {lattice}, vvl {vvl}:")
    urows, uextra = check_flat_policy_milc(u, b, lattice, vvl)
    log(f"U1 (MILC): {time.perf_counter() - t0:.1f} s")

    # L1. the Ludwig state at full size
    lcfg = LudwigConfig(lattice=tuple(args.ludwig), target=TargetConfig("cuda", device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(lcfg, seed=0)
    torch.cuda.synchronize()
    log(f"ludwig state {lcfg.lattice} (V = {math.prod(lcfg.lattice)}) on the card in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{(state.dist.data.numel() + state.q.data.numel()) * 4 / 1e9:.2f} GB")

    # L2. every Ludwig kernel against its plain version
    log(f"ludwig kernels at {lcfg.lattice}, vvl {lcfg.target.vvl}:")
    lrows = check_ludwig_kernels(state, lcfg, lcfg.target.vvl)
    # Q2. the Ludwig shapes in turns with the parent's K2
    if parent:
        turns.update(ludwig_turns(parent, state, lcfg.target.vvl))
    # Q5. K5L in every layout in turns with the parent's lb.cu
    if "k5l" in parent_libs:
        turns.update(k5l_turns(LbStep(ctypes.CDLL(str(parent_libs["k5l"])), "parent"), state,
                               lcfg, lcfg.target.vvl))
    else:
        log(f"Q5: no parent tree under {PARENT_SRC}; the parent's K5L is not timed")

    # L3. the Ludwig step, counted
    after_steps, last, lcounts, l3_ms = run_ludwig(state, lcfg)

    # L4. the unfused and the fused LB half-step, counted
    xcounts = lb_exhibit(last, lcfg)
    del last
    torch.cuda.empty_cache()
    # C1. K3C, the fused LC chain, in SoA and AoS, each graph launch counted
    log(f"C1: K3C (the fused LC chain) at {lcfg.lattice}:")
    crows, ccounts, k3c = check_lc_chain(state, lcfg, lcfg.target.vvl)

    # L5. the cuda engine against the torch engine, both on the card
    ludwig_engines(tuple(args.ludwig_small))

    # D1 (Ludwig). K8H and K5LH against their plain versions; D3. the sharded steps
    t0 = time.perf_counter()
    log(f"D1: K8H and K5LH at {lcfg.lattice}, vvl {lcfg.target.vvl}:")
    lhrows, d1counts = check_halo_ludwig(state, lcfg, lcfg.target.vvl)
    drows.update(lhrows)
    log(f"D1: K5LHO on the overlap split of {lcfg.lattice}, vvl {lcfg.target.vvl}:")
    lbrows, box_ludwig = check_box_ludwig(state, lcfg, lcfg.target.vvl)
    drows.update(lbrows)
    log(f"D1: K9H at {lcfg.lattice}, vvl {lcfg.target.vvl}:")
    k9hrows, tiled_ludwig = check_tiled_halo_ludwig(state, lcfg, lcfg.target.vvl)
    drows.update(k9hrows)
    d3, d3counts = sharded_ludwig(state, lcfg)
    d3["k5lho_split"] = box_ludwig
    d3["k9h"] = tiled_ludwig
    log(f"D1 (Ludwig), D3: {time.perf_counter() - t0:.1f} s")
    dcounts = {"dslash_halo": d2counts[None]["dslash_halo"],
               "wilson_normal_pre": d2counts["pre"]["wilson_normal_pre"],
               "lb_propagate_halo": d1counts["lb_propagate_halo"],
               "lb_step_pre": d3counts["lb_step_pre"],
               "wilson_normal_box": d2counts["overlap"]["wilson_normal_box"],
               "lb_step_box": d3counts["lb_step_box"],
               "lb_step_halo": d3counts["lb_step_halo"],
               "lb_step_halo@aosoa4": d3counts["lb_step_halo@aosoa4"],
               "wilson_normal_pre_tiled":
                   d2counts["pre_budget"]["wilson_normal_pre_tiled"],
               "wilson_normal_box_tiled":
                   d2counts["tiled_overlap"]["wilson_normal_box_tiled"]}
    decomp_line = {"decomposed": {
        "card": smi, "sharded_solve": d2, "sharded_step": d3,
        "kernels": {n: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
                    for n, r in drows.items()}}}

    # P1 at the Ludwig lattice, and P4. the bf16 LB step, counted
    t0 = time.perf_counter()
    log(f"P1: the policy instances at {lcfg.lattice}, vvl {lcfg.target.vvl}:")
    lmrows, lmextra = check_mixed_ludwig(state, lcfg, lcfg.target.vvl)
    p4, p4counts, sumcounts = mixed_ludwig(state, after_steps, lcfg, l3_ms,
                                           tuple(args.ludwig_small))
    log(f"P1 (Ludwig), P4: {time.perf_counter() - t0:.1f} s")
    # U1 at the Ludwig lattice
    t0 = time.perf_counter()
    log(f"U1: K3L's policy instances at {lcfg.lattice}, vvl {lcfg.target.vvl}:")
    ulrows, ulextra = check_flat_policy_ludwig(state, lcfg, lcfg.target.vvl)
    urows.update(ulrows)
    uextra.update(ulextra)
    log(f"U1 (Ludwig): {time.perf_counter() - t0:.1f} s")
    mixed_line = {"mixed_precision": {
        "card": smi,
        "kernels": {n: {**{k: r[k] for k in ("ms", "bound_ms", "plain_ms", "library_ms")},
                        **{**mextra, **lmextra}[n]}
                    for n, r in {**mrows, **lmrows}.items()},
        "refined_solve": p2, "refined_serving": p3, "ludwig_bf16": p4}}

    # Y1. every lattice kernel in every layout, against its SoA launch
    t0 = time.perf_counter()
    yrows = check_layout_kernels(u, b, lattice, state, lcfg, vvl)
    # Y2. the MILC solve in every layout, counted
    ymilc = solve_layouts(cfg, u, b, x_soa, iterations)
    # V1 (MILC). the block view at full width, counted
    t1 = time.perf_counter()
    v1 = {"milc": view_block_milc(cfg, u, b, x_soa, iterations)}
    # D2's trace of the overlap operator, after V1's strict kernel list (the
    # run's first profiler session, as before the trace existed)
    d2["overlap_trace"] = overlap_trace(cfg, u, b)
    # RS1. split reductions at full width, counted
    srows, split_line, scounts_rs = split_reductions(cfg, u, b, x_soa, iterations, vvl, state,
                                                     lcfg)
    v1_rs1_s = time.perf_counter() - t1
    # T4. the solve under the 227 KiB budget on K5T, counted; T5. the budgeted
    # serving and refined solves, counted
    t1 = time.perf_counter()
    nrows, ncounts, t4, k5t_tile = check_tiled_normal(cfg, u, b, x_soa, iterations, solve_s, vvl)
    nsrows, nscounts, t5 = check_tiled_normal_serving(cfg, u, b, k5t_tile, vvl, args.seed,
                                                      (p2["iterations"], x_p2))
    del x_p2
    log(f"T4, T5: {time.perf_counter() - t1:.1f} s")
    # U2. the plan autotuner: sweeps, cached tables, the tuned solve and steps
    t1 = time.perf_counter()
    ucounts, u2 = tuned_phase(cfg, u, b, x_soa, iterations, solve_s, state, after_steps, lcfg,
                              l3_ms, small, args.seed)
    log(f"U2: {time.perf_counter() - t1:.1f} s")
    del u, b, x_soa
    torch.cuda.empty_cache()
    # Y3. the Ludwig step in every layout x vvl, counted
    ygrid, ylcounts, yxcounts, ystages, yexhibit = ludwig_layouts(state, after_steps, lcfg)
    log("Y3: step_timed's stages in aos beside soa (ms): " + ", ".join(
        f"{k} {ystages['aos'][k]:.3f} vs {v:.3f} ({ystages['aos'][k] - v:+.3f})"
        for k, v in ystages["soa"].items()))
    # V1 (Ludwig). the block view's steps, counted
    t1 = time.perf_counter()
    v1["ludwig"] = view_block_ludwig(state, after_steps, lcfg)
    v1_rs1_s += time.perf_counter() - t1
    log(f"Y1-Y3: {time.perf_counter() - t0 - v1_rs1_s:.1f} s; V1, RS1: {v1_rs1_s:.1f} s")
    layouts_line = {"layouts": {
        "card": smi,
        "kernels": {lay: {n: {k: r[k] for k in ("ms", "bound_ms", "ratio_to_soa", "library_ms")}
                          for n, r in rows.items()} for lay, rows in yrows.items()},
        "milc_ms_per_iteration": {lay: v[1] for lay, v in ymilc.items()},
        "ludwig_ms_per_step": ygrid, "ludwig_step_timed_ms": ystages,
        "ludwig_lb_exhibit_ms": yexhibit}}

    # T1. the tiled kernel at the budget's plan, in SoA, then off SoA and in bf16
    trows, tplan = check_tiled_kernel(state, lcfg, lcfg.target.vvl, ptxas["k10"])
    ttile = (tplan.bx, tplan.by, tplan.bz)
    tlrows, k5l_ms = check_tiled_layouts(state, lcfg, lcfg.target.vvl, ttile)
    # Q4. K9 in turns with the parent's design, where its tree is unpacked
    parent_k9_k10 = (ParentK9K10(parent_libs["k9_k10"]) if "k9_k10" in parent_libs else None)
    if parent_k9_k10:
        turns.update(k9_turns(parent_k9_k10, state, lcfg, (tplan.bx, tplan.by, tplan.bz)))
    else:
        log(f"Q4: no parent tree under {PARENT_SRC}; the parent's K9 and K10 are not timed")

    # T2. the Ludwig step under the budget, counted
    tcounts, txcounts, _ = run_tiled(state, after_steps, lcfg, l3_ms)
    tlcounts, tl_step_ms = run_tiled_layouts(state, after_steps, lcfg, ttile)
    log(f"max memory allocated over L1-T2: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del state, after_steps
    torch.cuda.empty_cache()

    # T3. explicit tiles at the small lattice against the torch engine
    ludwig_tiled_small(tuple(args.ludwig_small))

    # R1. K10 against its plain version and the scan oracle
    log("R1: K10 (rwkv6_wkv: the state pass and the output pass):")
    rrows, wkv_floors = check_wkv_kernel(ptxas["k10"])
    # Q4. K10 in turns with the parent's design, beside the design's floor
    if parent_k9_k10:
        turns.update(k10_turns(parent_k9_k10))
        for name, floor in wkv_floors.items():
            turns[name]["design_floor_ms"] = floor

    # R2. the full-width prefill, counted
    rcfg, params, nbytes, rcounts, prefill_ms = rwkv_prefill()
    wkv_ms = rcfg.n_layers * rrows["rwkv6_wkv"]["bf16_ms"]
    log(f"R2: {rcfg.n_layers} K10 calls (state and output pass) at R1's bf16 time: "
        f"{wkv_ms:.3f} ms, {wkv_ms / prefill_ms:.3f} of the prefill")

    # R3. serving
    rwkv_serve(rcfg, params, nbytes)
    del params
    torch.cuda.empty_cache()

    # A1. K11 and K12 against their plain versions
    log("A1: K11 (flash_attention) and K12 (flash_attention_kvchunk):")
    arows = check_flash_kernels(ptxas["flash"], parent_libs.get("flash"))

    # A2. the full-width prefills, counted
    dcfg, params, p32, nbytes, acounts, prefill_ms = dense_prefill()
    for name, ms in zip(("flash_attention", "flash_attention_kvchunk"), prefill_ms):
        k_ms = dcfg.n_layers * arows[name]["ms"]
        log(f"A2: {dcfg.n_layers} {name} launches at A1's time: {k_ms:.3f} ms, "
            f"{k_ms / ms:.3f} of the prefill")

    # A3. serving
    dense_serve(dcfg, params, p32, nbytes)
    del params, p32
    torch.cuda.empty_cache()

    # 6. the kernel table, then the result
    table = (table_rows(PATH, counts, rows) + table_rows(LUDWIG_PATH, lcounts, lrows)
             + table_rows(LB_EXHIBIT_PATH, xcounts, lrows)
             + table_rows(TILED_PATH, tcounts, trows)
             + table_rows(TILED_EXHIBIT_PATH, txcounts, trows)
             + table_rows(TILED_LAYOUT_PATH, tlcounts, tlrows)
             + table_rows(NORMAL_TILED_PATH, ncounts, nrows)
             + table_rows(NORMAL_TILED_SERVE_PATH, nscounts, nsrows)
             + table_rows(LC_CHAIN_PATH, ccounts, crows)
             + table_rows(RWKV_PATH, rcounts, rrows)
             + table_rows(FLASH_PATH, acounts, arows)
             + layout_table_rows(PATH, {lay: v[0] for lay, v in ymilc.items()}, yrows)
             + layout_table_rows(LUDWIG_PATH, ylcounts, yrows)
             + layout_table_rows(LB_EXHIBIT_PATH, yxcounts, yrows)
             + table_rows(SERVE_PATH, scounts, brows)
             + table_rows(MIXED_PATH, p2counts, mrows)
             + table_rows(MIXED_SERVE_PATH, p3counts, mrows)
             + table_rows(MIXED_LUDWIG_PATH, p4counts, lmrows)
             + table_rows(MIXED_SUM_PATH, sumcounts, lmrows)
             + table_rows({**RS_BATCH_PATH, **RS_COMP_PATH, **RS_DTYPE_PATH,
                           "reduce_fold_split": RS_PATH["reduce_fold_split"]},
                          scounts_rs, srows)
             + table_rows(FLAT_POLICY_PATH, ucounts, urows)
             + table_rows(DECOMP_PATH, dcounts, drows))
    print(json.dumps(layouts_line))
    print(json.dumps(serve_line))
    if turns:
        print(json.dumps({"redesign": {"card": smi, "kernels": turns}}))
    print(json.dumps(mixed_line))
    print(json.dumps({"view_block": {"card": smi, **v1},
                      "split_reductions": {"card": smi, "rsplit": RSPLIT, **split_line}}))
    print(json.dumps({"tiled": {
        "card": smi, "solve": t4, "serving_and_refined": t5, "lc_chain": k3c,
        "k9": {n: {"ms": r["ms"], "k5l_ms": k5l_ms[n], "bound_ms": r["bound_ms"],
                   "ms_per_step": tl_step_ms.get(n)} for n, r in tlrows.items()}}}))
    print(json.dumps({"autotune": {
        "card": smi, "flat_policy": {n: {**{k: r[k] for k in ("ms", "plain_ms", "bound_ms")},
                                         **uextra[n]} for n, r in urows.items()}, **u2}}))
    print(json.dumps(decomp_line))
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
