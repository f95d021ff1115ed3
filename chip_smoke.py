#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (tidb_tpu_torch) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from tidb_tpu_torch/ops/csrc with
nvcc (sm_90a, one nvcc per source, all started together), then runs the
phases below; any failure exits non-zero.

1. Kernels against their plain PyTorch versions on the card.
   The fused segment update (tidb_segagg, which replaces B1 and B2) on
   fourteen cases: Q1's 16 accumulators (23 outputs) at its chunk shape,
   G in {1, 12, 26, 33, 300, 8192} and 2^16 (global atomics), ragged R,
   no sel, sel all false, a NULL column, operands 8 bytes off a 16-byte
   boundary and 40 accumulators (two launches); ids >= G and < 0 and
   int64 extremes throughout, each output bit-equal to
   plain_segment_accumulate. Its one-accumulator entry points (B1, B2) at
   Q1's chunk shape (R = 65,536) with G in {1, 12, 8192}, a G above the
   shared-memory budget, ragged R, ids >= G and int64 extremes: counts and
   int64 sums bit-equal, f32 sums within 1e-5 of each group's absolute
   mass (atomics add in a different order on every run). The hash probe
   (B3) on Q18's shape, random keys with duplicates, a same-home cluster,
   full-int64 keys, a build over capacity, the largest eligible build,
   ragged R, all misses and keys whose mix hits the EMPTY sentinel: (lo,
   hi) bit-equal to the plain window scan, and hi - lo equal to
   searchsorted's count (lo equal on every hit); B3 is now
   tidb_probe_count's lookup-only mode. The join's probe program
   (tidb_probe_count, which replaces B3 and the eager chain around it) on
   twenty-one cases (probe_count_cases): each route (direct, table,
   sorted) plain, with the LEFT pad, flags-only and at a ragged row count,
   a table above the shared-memory limit (cap 2^18) in both modes, a build
   holding the EMPTY-preimage keys, two-key range packing, hash packing
   and a chunk below one tile; NULL keys, sel holes, absent keys and
   INT64 extremes throughout: all seven outputs bit-equal to
   plain_probe_chunk. The built library's atomic opcodes are read with
   cuobjdump -sass. Then ops/bench_segsum.py at R = 2^20 and G in {16,
   256, 2048}: segment_count, segment_sum_f32 and segment_sum_i64 each
   beside one index_add_ of the same function, CUDA events after a
   warm-up, every exactness flag true (counts and int64 sums exact, the
   f32 sum within 1e-4 of the largest group); its JSON under OUT_DIR.
Grid. All 22 TPC-H queries at SF0.1 (the port's generator, seed 7, chunk
   capacity 8,192) through Session on cuda, each against an indexed sqlite
   oracle built here from the port's tables (sqlite_oracle), ordered, with
   the oracle's SQL variants, numbers within 1e-6 relative; twice, as
   loaded and after ANALYZE TABLE of the eight tables (the analyzed
   plans). Each run must
   keep the probe kernel's launch contract, take at least the fused
   fragments its plan calls for, and run the device generic aggregation
   exactly on Q2, Q3, Q7, Q8, Q9, Q10, Q11, Q13, Q15, Q16, Q17, Q18 and
   Q20, fused at least on Q15, Q17, Q18 and Q20. Q9 is empty at this
   scale and checks nothing.
Workloads (phase_workloads). A fresh Session on cuda, seed 7: SSB at SF1
   (storage/ssb.py: 1,500,000 orders, about 6M lineorder rows) and its 13
   queries, each against a numpy evaluation over the same generated
   arrays (numpy_ssb: the star join by key lookups, sums exact, rows
   equal as a multiset and in the ORDER BY's order, ties in any order);
   TPC-DS Q95 at the generator's sf 10 (storage/tpcds.py: 600,000
   orders, about 1.5M web_sales rows) against numpy_q95 (the order
   numbers of ws_wh's self-join and of both IN subqueries; count and
   sums exact). Each query runs once cold and WORKLOAD_WARM times warm,
   each run with the plan taken just before it, its fused fragments and
   its launches, held to the plan's launch contract (check_path; Q95's
   CTE is materialized at plan time, one more fused generic
   aggregation). Load seconds per table, the device bytes held after the
   load and each query's warm median are printed; the launches fill the
   kernels line's launches_workloads.
2. The load declares CLUSTER BY (l_shipdate) on lineitem, as the
   reference's does: a cold Q6 over the store in ingest order folds it,
   the re-sort runs at that statement's end (its host time printed), and
   lineitem must then be sorted with clustered_rows == n (phase_cluster).
   TPC-H Q1, Q6, Q3, Q5 and Q18 at SF1 (about 6M lineitem rows) through
   tidb_tpu_torch.session.Session on cuda, each compared with a numpy
   evaluation of the same query over the same generated arrays (decimals
   exact), on two paths. Each run has the kernels' launch counters, the
   join's probe-route counter and the pipeline's and segment store's
   counters set to 0 just before it and read just after. Every run must
   launch tidb_segagg exactly once per chunk its segment aggregation
   updates and tidb_probe_count exactly once per probe chunk, on every
   route, and the one-column and lookup-only entries never.
   The default path (columnar segment store, fused pipelines): Q1 and Q6
   run twice and must each run in FusedScanAggExec, one pinned copy per
   staged batch the first time and 0 bytes staged the second (the device
   buffer cache); Q3, Q5 and Q18 must run every inner join whose probe
   side is a plain scan (counted on the plan taken just before the run)
   in FusedScanProbeExec, and every generic aggregation on the device:
   fused over a plain scan (Q18's IN subquery), else on the classic
   tree's device path (Q3's, Q18's outer), counted against the plan. The
   classic path (tidb_tpu_pipeline_fuse = 0,
   tidb_tpu_columnar_enable = 0, the earlier raw tree) must give the same
   rows and run nothing fused. Then a 1,200,000-row table loaded with
   8,192-row segments (8 packed a batch) answers one aggregate and one
   join equal to numpy, through the fused executors, tidb_segagg once per
   staged batch. The probe chunks' arguments are recorded for phase 3.
   Then Q3, Q18 and Q18's IN subquery run once more with torch's sync
   debug mode set to "error" around every per-chunk step of the device
   generic aggregation (a device->host copy or any sync there fails), and
   a top-N report over lineitem runs with one sort key, with three, and
   with a LIMIT above the chunk capacity, each against numpy: the first
   two through FusedScanTopNExec, the last through the classic TopNExec.
   The sanitized step (phase_sanitized): SET tidb_tpu_sanitize = 1, then
   Q1, Q6, Q3, Q5 and Q18 once each, rows equal to the phase's (which
   equal numpy) and no SanitizerError; per statement the sanctioned
   device_get round trips, the lock-order edges witnessed, the non-fatal
   findings and the runtime edges the static lock graph lacks; then a
   Q6 whose scan pins are never closed must raise SanitizerError
   (pin-leak), and the sanitizer is disabled again.
   The graphs step (phase_graphs): every fused batch of the default path
   goes through utils/jitcache.py, which on the card captures each input
   signature's launches into a CUDA graph once and replays it. Q1, Q6,
   Q3, Q5 and Q18 each run eagerly (the explicit switch,
   jitcache.eager()) and then from an empty cache by graph replay until
   one plan runs a third time: rows equal to phase 2's and the eager
   run's, each run's launch contract held, and on that plan's second
   warm run no eager call and no capture, every
   fused batch a replay, the kernels' launches, probe routes and
   device_get round trips equal to the eager run's; the warm median of
   WARM_RUNS
   in each mode, the bytes the graphs hold and a profiled replayed run
   of Q1, Q6, Q3 and Q5 (Q1 eagerly too; Q18 unprofiled, a cut for the
   time limit). The sync-free pass empties the cache before each
   statement, so its wrappers see a warm-up and a capture.
3. Times: warm wall time (median of WARM_RUNS) and rows/s of each query fused
   with the buffer cache (the graphs step's replay medians), of Q1, Q6,
   Q3 and Q5 fused with its budget 0,
   the same staged inline at prefetch depth 0, and classic, and of Q3 in
   a fifth mode (generic_host:
   tidb_device_engine_mode = 'off', the host groupby); no profiled run
   of these modes since the SF10 phase (Q1 classic and Q3 on the host
   engine until then; the fused runs' profiles are the graphs step's;
   UNPROFILED: the profiler adds 10-40 s to a run; a profile gives device busy
   time, idle share, host->device copies split pinned/pageable with their
   bytes, device->host copies, host cudaMemcpyAsync and launch counts, top
   operators by device time); Q18's IN subquery alone on the device (it
   may copy device->host only in its finalize: at most 2 copies), and
   the peak device memory of Q18, its
   subquery and Q3; each kernel's time at its
   main-path shape beside its bound, its plain version's time and a
   library call as the yardstick (`index_add_` for B1/B2 with one
   accumulator, and for the fused update one `index_add_` of the [R, 23]
   stacked contributions; searchsorted left + right for B3 and
   tidb_probe_count), and the time of what each fused kernel replaces
   (the single-column calls; the eager probe chain). tidb_probe_count is
   timed on the recorded arguments of Q18's table route (flags-only and
   full), Q3's direct route and Q5's sorted route (a phase-1 case of the
   route where the plan takes it nowhere), and on a cap-2^18
   table.
Server. The MySQL-protocol server over the SF1 catalog after phase 3
   (phase_server): Server(port=0, status_port=0, device="cuda") started;
   Q1, Q6, Q3, Q5 and Q18 by COM_QUERY over one connection, each against
   numpy and the session's rows, its wall time beside phase 3's median
   and its launches (the statements summary's per-thread dispatches)
   equal to a solo in-process run's; 800 prepared point-selects on
   orders by o_orderkey (COM_STMT_PREPARE / COM_STMT_EXECUTE) from 16
   connections in a client process of their own (point_clients), keys
   from seed 7 with 10% absent, the default 250 us batch window, every
   row against numpy, at least one batch of more than one member
   (statements/s, p50/p99, mean batch size printed); Q1 and Q3
   (CONCURRENT_QUERIES; Q18 too until the SF10 phase) from
   4 connections at once (the scheduler's workers run them one at a
   time on the catalog lock), each statement's rows and launches (its
   slow-log row) equal to its solo run's, their fused batches replaying
   CUDA graphs while the other connections run; KILL QUERY from a second connection 0.2 s
   into Q18 must give 1317 and Q18 under max_execution_time = 50 must
   give 3024, then Q1 and Q18 right on both connections, no prefetch
   thread alive and no device buffer cache entry added by a cut-short
   statement; GET /status and /metrics (the plan-cache, device-cache,
   batch-size and launch families); shutdown(drain=True) leaving no scheduler, DDL or accept
   thread; `python -m tidb_tpu_torch --port 0 --status-port -1
   --load-tpch 0.01` as a subprocess answering Q6, exit 0 at SIGINT.
4. The refresh phase (phase_refresh), on the phase-2 SF1 session after
   phase 3: keys, index access and the write path. A duplicate o_orderkey
   and a duplicate (l_orderkey, l_linenumber) are refused with the
   duplicate-key error, the row counts unchanged; the primary-key checks'
   share of the SF1 load is printed. A point get on orders plans PPointGet
   and l_orderkey's equality prefix plans PIndexRangeScan (an
   l_orderkey BETWEEN plans what the cost gate picks), each against numpy,
   timed first (the sorted index build) and warm. TPC-H RF1 (clause
   2.5.2: 1,500 new orders and their lineitems by multi-row INSERT ...
   VALUES, storage/tpch_refresh.py) runs in one explicit transaction;
   before COMMIT a second Session on the same catalog reads the pre-RF1
   Q1 and Q6 and the writer its own provisional rows through the fused
   pipeline's marker path. The COMMIT must auto-analyze orders and
   lineitem (the reference's rule: no statistics, at least 1,024 rows,
   rows modified; the bulk load analyzes nothing): its time is printed
   with and without the analyze share, and the five queries' plans before
   RF1 and after the COMMIT. RF2 (clause 2.5.3: the 1,500 oldest orders)
   deletes lineitem and orders by multi-table DELETE through a key table
   (a hash join: tidb_probe_count runs). An UPDATE of the 1994 lineitems'
   l_discount rolled back leaves Q6 as it was; committed, it moves Q6 to
   numpy's new value. A scratch copy (INSERT ... SELECT) truncated gives
   fused Q6 zero rows, and a re-insert is seen. After RF1, RF2 and the
   UPDATE, Q1, Q6, Q3, Q5 and Q18 equal numpy over an independent array
   model of the tables, and the first Q1 and Q6 after each DML restage
   while the second stage 0 B (when the DML's delta made a CLUSTER BY
   fold due, the first run re-sorts lineitem at its end, the next run
   restages the moved rows and one more stages 0 B). Every statement and
   query is timed, and its launches, staging and cache outcomes
   recorded; tidb_segagg and tidb_probe_count must both launch in the
   phase, the off-path entries never.
5. The schema phase, on the same session. tidb_tpu_compaction on and
   off over the same ingest (phase_compaction): a date-clustered copy of
   lineitem's Q6 columns gets two thirds of its rows, then four appends
   of later dates, Q6 after each against numpy; with the flag on the
   background worker folds each append (its queue drained after the
   query), off the statement folds inline; the rows, the physical order
   and clustered_rows must agree and the worker's rebuilds must have
   happened. Then phase_schema: a copy of lineitem's query columns
   PARTITION BY RANGE (l_orderkey) at the order keys' quartiles, filled
   by the bulk path: Q1 and Q6 on the first quartile plan a PartitionScan
   of p0 feeding tidb_segagg, Q3 over the copy, each against numpy; a
   row past a bound-less RANGE is refused. A copy with FOREIGN KEY
   (l_orderkey) REFERENCES orders, CHECKs from TPC-H's domains and a
   stored DECIMAL(15,4) generated column l_extendedprice * (1 -
   l_discount): the load's FK, CHECK and generated-column times, the sum
   of the generated column by Q1's groups against numpy, RF1 through it
   (auto-analyze off around it since the SF10 phase),
   a violating row, an orphan key and the delete of a referenced order
   refused, RF2 in TPC-H's order. ALTER TABLE ADD, MODIFY and DROP
   COLUMN on orders with Q3 against numpy after each; a SAVEPOINT inside
   RF1 rolled back to (Q1 against numpy, RF1's orders kept); SELECT ...
   FOR UPDATE in one session refusing another session's UPDATE and
   locking read until COMMIT. tidb_segagg and tidb_probe_count must both
   launch in the phase.
6. Statistics, EXPLAIN ANALYZE, windows and views, on the same session.
   phase_stats: ANALYZE TABLE of the eight tables, timed per table; Q1,
   Q6, Q3, Q5 and Q18 under the analyzed plans against numpy over the
   tables' live rows (warm median of WARM_RUNS, one profiled run of Q6: device
   busy time; tidb_segagg once per aggregated chunk,
   tidb_probe_count once per probe chunk); EXPLAIN ANALYZE of Q1 (the device buffer cache cleared,
   so it stages), Q3 and Q18: the root's actRows must equal the query's
   row count, the operators' dispatches must add up to the kernels'
   launches in the statement and the profile line's xfer_bytes to the
   bytes the fused pipeline and the classic scan staged. phase_window:
   ROW_NUMBER and RANK by customer over orders' price, a running SUM by
   order date, LAG and an AVG over a ROWS frame, each over the live orders
   up to WINDOW_SHARE of the order keys (every order until the SF10 phase)
   against numpy; the official TPC-H Q15 (CREATE VIEW revenue0, the
   query, DROP VIEW) against numpy and the inlined Q15; SHOW TABLES, SHOW
   CREATE TABLE lineitem and SHOW INDEX FROM orders printed.
7. The storage phase (phase_storage), on the same session, its tables in
   a scratch database. The delta engine: orders' columns, no key,
   ENGINE=delta, filled by INSERT ... SELECT from orders (the orders up
   to STORAGE_SHARE of the order keys since the SF10 phase), then 250
   single-row autocommit INSERTs of fresh keys (all still buffered when
   the next read starts; 5,000 in earlier runs reached the 4,096-row
   bulk append); an aggregation by o_orderpriority and Q3 over it against
   numpy; 125 of the same INSERTs into a columnar copy of the same rows,
   per-statement times of both engines printed. (10,000 and 1,000 until
   the planner phase was added, 1,000 and 500 until the graphs step:
   cut to keep the script inside its time limit.) CREATE TABLE ... AS SELECT of lineitem's
   revenue by order (one row per order, the same orders), joined to orders under a date
   filter against numpy; CREATE TABLE ... LIKE orders (engine, CHECKs,
   keys, no rows). SELECT * FROM orders INTO OUTFILE under build/ for
   orders' first LOAD_ROWS keys, LOAD DATA INFILE into a LIKE copy,
   rows/s both ways; Q3 over the loaded copy equals numpy over the same
   keys. Over the wire: one connection's TEMPORARY
   orders of 1,000 rows read by its Q3 while a second connection's Q3
   reads the permanent table, both against numpy; the temp table gone
   after the first disconnects, torch.cuda.memory_allocated() and the
   device buffer cache's entries of it, which must be none, recorded. information_schema's
   tables (row counts against the catalog), columns, statistics (after
   ANALYZE), processlist and statements_summary read in process and over
   the wire alike. DROP DATABASE refused while an FK points into it, then
   dropped, no device buffer cache entry of its tables left. Each step
   prints its wall time and launches; tidb_segagg and tidb_probe_count
   must both launch.
8. The planner phase (phase_planner), on the same session after the
   storage phase, with numpy over the tables' live rows as the reference.
   Spill: Q18 with tidb_device_engine_mode = 'off' under
   /*+ MEMORY_QUOTA(256 MB) */ (SPILL_QUOTA: at 64 MB Q18's hash-join
   builds alone, which cannot spill, pass the quota) must spill and
   equal numpy; an ORDER BY l_extendedprice DESC, l_orderkey,
   l_linenumber over lineitem's three columns (the rows of SORT_SHARE of
   the order keys, under SORT_QUOTA, since the SF10 phase) must
   spill and equal numpy's lexsort (its length, the first and last 1,000
   rows, every row's keys in order and every 1,009th price); Q18 again
   with no quota; Q18 in the default mode under the quota (completed or
   QueryOOMError, recorded); the ORDER BY with
   tidb_enable_tmp_storage_on_oom = OFF must raise QueryOOMError; no
   spill file may be left. Plan feedback, from an empty store and with
   the text statements' plan cache on (warm runs come from it): Q18 four
   times, each run's plan (taken from the session as it ran) held to its
   launch contract, with and without the eager partial, the store's
   push-down decision before and after, rows against numpy;
   information_schema.plan_feedback equal to the status port's
   /plan_feedback; EXPLAIN ANALYZE of Q3 with its est and drift columns;
   a many-to-many join (orders to 16 build rows per key) whose fused
   probe overflows its first tile, twice: the second run's join_tiles is
   raised by the tile hint and it makes fewer expand calls. The cascades
   memo (tidb_enable_cascades_planner = 1): Q3 and Q5 equal numpy, the
   memo's modeled join cost at most the greedy orderer's. IndexJoinExec:
   the orders of one date joined to customer and lineitem under the memo
   plan IndexJoin in EXPLAIN, equal numpy, timed beside the hash join. A
   GLOBAL binding of Q3 with a LEADING hint that changes its join order:
   the statement runs the hinted plan with the same rows, and DROP
   BINDING restores the plan. Every step prints its wall time, its
   tidb_segagg and tidb_probe_count launches, its spill bytes and its
   trackers' max_consumed; every tracker must end at consumed 0, and
   both kernels must launch in the phase.
9. The mesh phase (phase_mesh), on the same SF1 catalog after the
   planner phase: the mesh tier (tidb_tpu_torch/parallel) under
   Session(mesh=...), each mesh fragment one program of
   utils/jitcache.py (namespaces distagg, distjoinagg, fragment and
   aggcombine: a CUDA graph per signature after its warm-up, reading a
   resident sharding in place). First the single-card session's rows of Q1, Q6,
   Q3, Q5 and Q18 and their warm medians of WARM_RUNS. On a mesh of the one card
   (make_mesh(), as the reference serves one chip) each query's rows must
   equal numpy over the tables' live rows and the single-card rows
   exactly, its executor classes are printed, tidb_segagg must launch
   for Q1 and Q6 (DistAggExec) and tidb_probe_count for Q3, Q5 and Q18
   (their mesh joins), the off-path entries never; one cold run on the
   eager path (jitcache.eager()), then graph runs until one plan runs a
   third time (mesh_graph_runs): the rows equal the eager rows every
   run, the plan's first warm run captures a mesh program and its second
   captures nothing (every program a replay), whose tidb_segagg and
   tidb_probe_count launches and device_get round trips equal an eager
   run of the same plan right after it (the two warm times recorded
   beside the single-card medians with no limit), and the graphs hold at
   most tidb_tpu_graph_cache_bytes (each statement's memory pool well
   within it: a one-part mesh's exchange is the identity). Then
   rounds of Q1, Q5 and Q18 in turn (mesh_mix, as a mixed client would
   send them; at most MESH_MIX_ROUNDS), the graphs within the bound after
   every run: in the first round whose plans equal the two rounds'
   before (plan feedback may still move Q18's) after a round with no
   warm-up, every program must replay where the three statements' pools
   fit the bound together; where they do not, its captures are printed. With tidb_device_cache_bytes a
   quarter of lineitem's table bytes, Q1 and Q6 stream in at least two
   batches and equal the resident runs, with the same graph checks
   (every batch's fragment and every merge after the first a replay).
   An UPDATE of lineitem (the last order's quantities up by one and back)
   retires its resident sharding: its programs leave the cache, the
   card's allocated bytes after Q1 on the new sharding stay within half a
   sharding of those before (mesh_retire). The same five queries on four shards laid over the
   one card (MESH_SHARDS: the all_to_all exchange and the merges run on
   the card), with the same checks; then the 22 TPC-H queries at SF0.1
   on those four shards against the grid's sqlite oracle (the programs'
   warm-ups; MESH_GRID_RECHECK's four twice more: their captures, then
   replays equal to sqlite, the third run replaying). Then a
   Server(mesh=...) connection's Q1 and Q3 must equal the in-process
   rows; the point-select fleet (16 connections of MESH_POINT_STMTS)
   against that server must equal numpy with no statement batched (a
   mesh session offers the batcher nothing, as the reference's does);
   MESH_MEM_CONNS connections each run Q6 three times against it, and
   the card's allocated bytes, the captures and the graphs' bytes after
   each, their peak and the bytes once they closed are recorded (each
   connection stages its own sharding and captures its own graphs). The phase
   prints its time, its launches, its probe_count calls by route and
   mode, and how often the mesh fell back to one device, by reason. It
   records the largest tidb_segagg call (Q1 on the one-card mesh: a
   shard is all of lineitem) and the largest tidb_probe_count call of
   every route and mode it took; after the phase each is checked
   against its plain version and timed (mesh_kernel_rows), rows of the
   kernels line of their own.
10. The DCN phase (phase_dcn), last, beside the same single-card
   session: DCN_WORKERS worker processes (python -m
   tidb_tpu_torch.parallel.dcn --device cuda, each its own CUDA context
   on the card, DCN_WORKER_THREADS torch threads apiece) under one
   Cluster whose merge session is on the card. lineitem and orders
   SHARD BY HASH(key) SHARDS 8 (co-partitioned), customer, supplier,
   nation and region broadcast, every column of the single-card tables
   shipped; load seconds and wire bytes per table and each worker
   process's device memory printed. Q1, Q6, Q3 and Q5, one cold run and
   DCN_WARM warm: rows equal to the single-card session's (floats within
   1e-12 relative) and numpy, warm medians beside the single card's;
   each worker's own tidb_segagg and tidb_probe_count launches read over
   the metrics_snapshot RPC before and after each run, and the
   coordinator's (this process: the merge session's final aggregate)
   from its own counters: every worker's Q1 must launch tidb_segagg and
   its Q3 tidb_probe_count, and Q1's final merge tidb_segagg. Q18 is
   refused typed, as the reference's Cluster refuses it. orders
   resharded online to SHARDS 9 (DCN_RESHARDS; 12 would stay co-located
   with lineitem at two workers) while two readers run an orders
   aggregate (each read equal to the expected rows) and a writer inserts
   orders by 2PC, the fleet's bound on a statement's gate wait raised
   from tidb_tpu_reshard_gate_wait_ms's 10 s to DCN_GATE_WAIT_S (the
   slowest statement's wait is printed); then Q3 must shuffle orders and
   equal the single card and numpy. TPC-H RF1's rows as one 2PC INSERT
   a table and RF2's as one 2PC DELETE a table: Q1 then equals a numpy
   model of the updated tables (the single-card session keeps its rows).
   The wire witness: the coordinator's sanitizer on for one Q1, one Q3
   and one 2PC INSERT (and the DELETE of its row): report() may hold no
   wire-* finding (every request sent is in the port's committed
   protocol model). Q1 under max_execution_time = 20 ms raises
   QueryTimeoutError and the workers' deadline or cancel counters move.
   A fleet of its own (two more workers) holds orders alone (its rows up
   to DCN_SIDE_SHARE of the order keys since the SF10 phase, as the
   failover fleet below): a third
   worker joins (add_worker) and drains out (remove_worker), orders'
   count and sum equal numpy after each (moving lineitem's shards too
   took 99-107 s of host work). A second fleet of two
   workers with replicas={0: 1, 1: 0} holds orders alone (mirroring
   both tables through the reshard would re-dump each at every shard's
   cutover): worker 1 is SIGKILLed and two orders aggregates still equal
   their answers through the replica, tidb_tpu_dcn_failover_total
   moving. information_schema.dcn_worker_stats and cluster_info show
   the three fleets. No worker process and no spill file may be left.
11. SF10 (phase_sf10), last, on a fresh Session on the card after every
   SF1 session is closed and the device buffer cache and the built
   programs are emptied: TPC-H at SF10 from the in-repo generator
   (60,001,162 lineitem rows, as the reference's SF10 rehearsal,
   SF10_REHEARSAL.json), with tidb_mem_quota_query at SF10_QUOTA (the 2
   GiB default stops Q18 at this scale). The load's generation and
   ingest seconds per table, its primary-key checks, the host's MemTotal
   and peak RSS and the host time of one lineitem.live_rows are printed.
   Q1, Q6 and Q5 run as the first three statements (the order that
   filled the card at SF1 before the join estimate and the probe's
   expansion were repaired), then Q3 and Q18, each once cold and then
   warm until a warm run captures no CUDA graph (at most SF10_WARM_MAX);
   each run is held to the launch contract of the plan it ran (taken
   from the session as it ran, plans_run: planning again would read every
   table's live rows once more) and prints its wall time, max_memory_allocated,
   staged bytes, tidb_segagg and tidb_probe_count launches and
   device_get round trips; each query's rows equal numpy over the
   generated arrays (decimals exact, averages within 1e-12 relative; numpy
   runs on a thread of its own beside the warm runs, once no statement
   moves a row) and its warm rows its cold rows. Lineitem must be re-sorted by l_shipdate
   and the warm Q6 prune segments; the graphs' bytes stay within
   tidb_tpu_graph_cache_bytes. Q18 then runs on the host engine under
   /*+ MEMORY_QUOTA */ at a quarter of lineitem's column bytes (the
   rehearsal's budget): rows identical to the resident run's, bytes
   spilled, every tracker at 0 and no spill file left. Q6 on a mesh of
   the one card, resident (lineitem's 6.8 GB are under
   tidb_device_cache_bytes) and streamed (the sysvar at a quarter of
   lineitem's bytes, two or more batches), equals the single card's rows,
   resident three runs (the programs' warm-up, capture and replay) and
   streamed two (the first run's second batch captures): the last run
   all replays; the mesh graphs' bytes must stay under half of
   lineitem's bytes (the resident sharding is read in place, not copied)
   and the cache within its quota.
The full report goes to chip_smoke.json under OUT_DIR.

Depth cuts for the SF10 phase's share of the 1,200 s limit (every path
is still driven; the earlier depth in parentheses): WARM_RUNS = 1 warm
run in the SF1 phases' medians (3: phase 3, the graphs step, stats, the
mesh), DCN_WARM = 1 (3), WORKLOAD_WARM = 1 (2), 16 x 50 point-selects
(16 x 100), Q1 and Q3 from the server phase's 4 analysts (and Q18), no
profile of phase 3's classic Q1 and host-engine Q3 nor of the graphs
step's Q6, Q3 and Q5 replays, LOAD_ROWS 100,000 (300,000), the storage phase's INSERT ...
SELECT and CTAS, the window queries and the DCN side fleets over a
quarter of the orders (STORAGE_SHARE, WINDOW_SHARE, DCN_SIDE_SHARE: all
of them), the planner's spilling ORDER BY over half of lineitem under
SORT_QUOTA (all of it under SPILL_QUOTA), auto-analyze off around the
schema phase's RF1 into its constrained copy. For the mesh's graph
checks: the mesh phase's warm times are its graph checks' own runs (no
extra timed runs), the four-shard grid's second and third runs only
MESH_GRID_RECHECK's four queries (all 22), the SF10 streamed mesh Q6 two
runs (three).

Plan feedback is on in every phase, as it is by default: a launch check
holds each run to the plan taken just before it by `planned`, which
plans as the session does (the feedback store's hints and its push-down
decision). The server phase compares each wire statement's launches
with a solo run's, so it pins the plan: tidb_opt_agg_push_down = 0 for
the phase (a user's pin that feedback never overrides), and each query
runs until two runs in a row take the same plan (settle_plan).

The card's name and power limit are printed first; the line before the
last is one JSON object {"kernels": [...]}: per kernel its name, route,
source, the TPU kernel it replaces, the launches of phase 2's main path
(`launches`) and of each later phase (`launches_refresh`,
`launches_schema`, `launches_stats`, `launches_window`,
`launches_server`, `launches_storage`, `launches_planner`,
`launches_mesh`, `launches_dcn`, `launches_workloads`, `launches_sf10`;
the mesh's launches sit only on the rows
at the mesh's own shapes, `segagg.mesh` and
`probe_count.mesh_<route>_<mode>`; the DCN's are the workers' and the
coordinator's, a probe_count route's on the row of its route and mode;
SF10's one-card mesh's tidb_segagg on segagg.mesh),
its largest
error against the plain version, and its time, its plain version's, its
bound with what bounds it, and a library call's; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or without the
repository beside it, it prints no result and exits non-zero."""

import contextlib
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12    # H100 SXM non-tensor FP32 peak, used for adds
# timed warm runs of a query in the SF1 phases' medians (3 until the SF10
# phase took its share of the time limit)
WARM_RUNS = 1
Q1_ROWS = 65536             # Q1's chunk capacity at SF1 (tidb_max_chunk_size)
Q1_GROUPS = 12              # (3 returnflags + NULL) x (2 linestatuses + NULL)
OUT_DIR = "chiprun_out"
I64_MAX = (1 << 63) - 1
M64 = (1 << 64) - 1
FP_SALT = 0x9E3779B97F4A7C15  # the hash probe's fingerprint salt
# operations per probe in B3: two splitmix64 tails (xor, shift, multiply
# twice each, then the final xor-shift and the EMPTY remap: 9 each) and,
# per slot read, a slot index, a compare against EMPTY and the fingerprint
MIX_OPS, SLOT_OPS = 18, 3


_T0 = time.perf_counter()


def log(*a):
    # seconds since the script started, so every phase's share of the
    # time limit can be read off the output
    print(f"[{time.perf_counter() - _T0:7.1f} s]", *a, flush=True)


def card_line() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def device_ms(torch, fn, graph: bool, calls: int = 20, reps: int = 10) -> float:
    """Device time per call. With `graph`, replays a CUDA graph of `calls`
    calls, so the host's launch cost drops out; a function that cannot be
    captured (the plain versions synchronise on boolean-mask indexing) is
    timed as a loop of calls between CUDA events, host gaps included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()  # warm-up on the capture stream
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            g.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (reps * calls)
    start.record()
    for _ in range(reps * calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(torch, np, seg_mod):
    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    info = np.iinfo(np.int64)
    extremes = np.array([info.max, info.min, info.max - 1, info.min + 1, -1, 1, 0],
                        dtype=np.int64)
    over_budget = 16384  # 16384 x 8 B = 128 KiB > the kernel's 96 KiB budget
    cases = [(Q1_ROWS, 1), (Q1_ROWS, Q1_GROUPS), (Q1_ROWS, 8192),
             (Q1_ROWS, over_budget), (Q1_ROWS + 37, Q1_GROUPS), (1000, 300)]
    err = {"segsum_count": 0, "segsum_i64": 0, "segsum_f32": 0.0}
    for R, G in cases:
        seg = rng.integers(0, G, R)
        bad = rng.random(R) < 0.1
        seg[bad] = G + rng.integers(0, 7, int(bad.sum()))  # ids >= G drop
        seg_t = torch.from_numpy(seg.astype(np.int64)).to(dev)
        mask = torch.from_numpy(rng.random(R) < 0.5).to(dev)
        dec = torch.from_numpy(rng.integers(-10**13, 10**13, R, dtype=np.int64)).to(dev)
        ext = torch.from_numpy(extremes[rng.integers(0, len(extremes), R)]).to(dev)
        f = torch.from_numpy(rng.standard_normal(R).astype(np.float32)).to(dev)

        got = seg_mod.segment_count(mask, seg_t, G)
        want = seg_mod.plain_segment_count(mask, seg_t, G)
        if not torch.equal(got, want):
            raise AssertionError(f"segsum_count R={R} G={G} differs from plain")
        for name, vals in (("decimal", dec), ("extremes", ext)):
            got = seg_mod.segment_sum_i64(vals, seg_t, G)
            want = seg_mod.plain_segment_sum_i64(vals, seg_t, G)
            if not torch.equal(got, want):
                raise AssertionError(f"segsum_i64 {name} R={R} G={G} differs from plain")
        got = seg_mod.segment_sum_f32(f, seg_t, G).double()
        want = seg_mod.plain_segment_sum_f32(f, seg_t, G).double()
        mass = seg_mod.plain_segment_sum_f32(f.abs(), seg_t, G).double()
        diff = (got - want).abs()
        if bool((diff > 1e-5 * mass + 1e-6).any()):
            raise AssertionError(f"segsum_f32 R={R} G={G}: max diff {float(diff.max())}")
        err["segsum_f32"] = max(err["segsum_f32"], float(diff.max()))
        torch.cuda.synchronize()
        log(f"kernel check R={R} G={G}: count, i64 (decimal, extremes) bit-equal; "
            f"f32 max |diff| {float(diff.max()):.3e}")
    return err


Q1_DECIMALS = 7  # Q1's decimal SUMs and AVGs: two limbs and a count each


def q1_accs(torch, seg_mod, vals, masks, G, dev):
    """Q1's 16 accumulators (23 [G] outputs) over `vals`/`masks` (one per
    decimal aggregate): occ, count(*), then a two-limb sum and a count per
    decimal SUM/AVG, as executor/aggregate.py's update builds them."""
    def z():
        return torch.zeros(G, dtype=torch.int64, device=dev)

    accs = [seg_mod.SegAcc("count", z()), seg_mod.SegAcc("count", z())]
    for v, m in zip(vals, masks):
        accs.append(seg_mod.SegAcc("limbs", z(), vals=v, mask=m, out_hi=z()))
        accs.append(seg_mod.SegAcc("count", z(), mask=m))
    return accs


def segagg_cases():
    """name -> (R, G, options) of the fused kernel's phase-1 cases."""
    cases = {f"mixed_G{G}": (Q1_ROWS, G, {}) for G in (1, 12, 26, 33, 300, 8192)}
    cases.update({
        "q1_shape": (Q1_ROWS, Q1_GROUPS, {"q1": True}),
        "global_atomics": (Q1_ROWS, 1 << 16, {}),  # 2 x 512 KiB > the 96 KiB budget
        "ragged_r": (Q1_ROWS + 37, Q1_GROUPS, {}),
        "ragged_hist": (1000, 300, {}),
        "no_sel": (Q1_ROWS, 26, {"no_sel": True}),
        "all_false": (Q1_ROWS, Q1_GROUPS, {"all_false": True}),
        "misaligned": (Q1_ROWS + 3, Q1_GROUPS, {"misaligned": True}),
        "forty_accs": (Q1_ROWS, Q1_GROUPS, {"many": 40}),
    })
    return cases


def make_segagg_case(torch, np, seg_mod, R, G, opts, seed, dev):
    """(seg, sel, accs) on the card: ids with a tenth at or above G and a
    twentieth below 0, outputs holding random state, int64 extremes and
    decimals, masks with NULLs; `misaligned` offsets every row operand by
    one element from a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    off = 1 if opts.get("misaligned") else 0

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t[off:] if off else t

    n = R + off
    seg = rng.integers(0, G, n)
    bad = rng.random(n)
    seg[bad < 0.1] = G + rng.integers(0, 7, int((bad < 0.1).sum()))
    seg[bad > 0.95] = -rng.integers(1, 4, int((bad > 0.95).sum()))
    sel = rng.random(n) < 0.7
    if opts.get("all_false"):
        sel[:] = False
    info = np.iinfo(np.int64)
    pool = np.array([info.max, info.min, info.max - 1, info.min + 1, -1, 1, 0], np.int64)

    def vals(i):
        if i % 2:
            return put(pool[rng.integers(0, len(pool), n)])
        return put(rng.integers(-10**13, 10**13, n, dtype=np.int64))

    def mask():
        return put(rng.random(n) < 0.8)

    def state():
        return torch.from_numpy(rng.integers(-10**6, 10**6, G, dtype=np.int64)).to(dev)

    if opts.get("q1"):
        accs = q1_accs(torch, seg_mod, [vals(i) for i in range(Q1_DECIMALS)],
                       [mask() for _ in range(Q1_DECIMALS)], G, dev)
        for a in accs:
            a.out.copy_(state())
            if a.out_hi is not None:
                a.out_hi.copy_(state())
    elif opts.get("many"):
        accs = [seg_mod.SegAcc("sum", state(), vals=vals(i), mask=mask())
                for i in range(opts["many"])]
    else:
        null = mask()
        null.zero_()  # a column that is NULL on every row
        accs = [seg_mod.SegAcc("count", state()),
                seg_mod.SegAcc("count", state(), mask=mask()),
                seg_mod.SegAcc("count", state(), mask=null),
                seg_mod.SegAcc("sum", state(), vals=vals(0), mask=mask()),
                seg_mod.SegAcc("sum", state(), vals=vals(1)),
                seg_mod.SegAcc("limbs", state(), vals=vals(2), mask=mask(), out_hi=state()),
                seg_mod.SegAcc("limbs", state(), vals=vals(3), mask=null, out_hi=state()),
                seg_mod.SegAcc("limbs", state(), vals=vals(5), out_hi=state())]
    return put(seg), None if opts.get("no_sel") else put(sel), accs


def check_segagg_case(torch, seg_mod, seg, G, sel, accs) -> int:
    """tidb_segagg against plain_segment_accumulate on the same state;
    raises unless every output is bit-equal. Returns the launches made."""
    plain = []
    for a in accs:
        b = copy.copy(a)
        b.out = a.out.clone()
        b.out_hi = None if a.out_hi is None else a.out_hi.clone()
        plain.append(b)
    n0 = seg_mod.LAUNCHES["segagg"]
    seg_mod.segment_accumulate(seg, G, sel, accs)
    seg_mod.plain_segment_accumulate(seg, G, sel, plain)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(accs, plain)):
        if not torch.equal(a.out, b.out) or (
                a.out_hi is not None and not torch.equal(a.out_hi, b.out_hi)):
            raise AssertionError(f"segagg accumulator {k} ({a.kind}) differs from plain")
    return seg_mod.LAUNCHES["segagg"] - n0


def phase_segagg(torch, np, seg_mod) -> dict:
    """Phase 1 for the fused kernel: every case of segagg_cases on the card,
    each bit-equal to plain_segment_accumulate."""
    out = {}
    for i, (name, (R, G, opts)) in enumerate(segagg_cases().items()):
        seg, sel, accs = make_segagg_case(torch, np, seg_mod, R, G, opts, 3000 + i, "cuda")
        launches = check_segagg_case(torch, seg_mod, seg, G, sel, accs)
        want = -(-len(accs) // seg_mod.MAX_ACCS)
        if launches != want:
            raise AssertionError(f"segagg {name}: {launches} launches, expected {want}")
        outs = sum(2 if a.kind == "limbs" else 1 for a in accs)
        out[name] = {"R": R, "G": G, "accumulators": len(accs), "outputs": outs,
                     "launches": launches}
        log(f"segagg check {name}: R={R} G={G} {len(accs)} accumulators ({outs} "
            f"outputs), {launches} launch(es): bit-equal to plain")
    return out


def sass_atomics(path: str, nvcc: str) -> dict:
    """Atomic opcodes per kernel in a built library (cuobjdump -sass, from
    nvcc's directory): whether 64-bit shared-memory adds are one
    ATOMS.ADD.64 or a CAS loop."""
    import re  # local: numpy_q5 names its region table `re`

    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    try:
        r = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                           timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        return {"error": str(e)}
    found, fn = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)(?:\.[A-Z0-9_]+)+)", line):
            found.setdefault(fn, {})
            found[fn][op] = found[fn].get(op, 0) + 1
    return found or {"error": (r.stderr or "no atomics found")[-500:]}


def _unshift(y: int, s: int) -> int:
    """Inverse of x ^ (x >> s) on 64 bits."""
    x, t = y, y >> s
    while t:
        x ^= t
        t >>= s
    return x


def empty_preimage(salt: int) -> int:
    """The int64 key whose splitmix64 tail (with `salt`) has low 32 bits
    0x7FFFFFFF, the probe table's EMPTY sentinel (the tail is invertible)."""
    h = _unshift(0x7FFFFFFF, 31)
    h = (h * pow(0x94D049BB133111EB, -1, 1 << 64)) & M64
    h = _unshift(h, 27)
    h = (h * pow(0xBF58476D1CE4E5B9, -1, 1 << 64)) & M64
    h = _unshift(h, 30) ^ salt
    return h - (1 << 64) if h >= (1 << 63) else h


def probe_cases(np):
    """name -> (sorted int64 build keys, int64 probe keys) for B3."""
    rng = np.random.default_rng(2027)
    R = Q1_ROWS
    info = np.iinfo(np.int64)
    ext = np.array([info.min, info.min + 1, -1, 0, 1, info.max - 1, info.max, info.max])
    q18 = np.sort(rng.choice(np.arange(1, 1_500_001), 57, replace=False))
    q18_probes = rng.integers(1, 1_500_001, R)
    q18_probes[rng.integers(0, R, 399)] = rng.choice(q18, 399)  # ~7 lines per key
    pre = [empty_preimage(0), empty_preimage(FP_SALT)]
    dups = np.repeat(rng.integers(0, 1 << 40, 1 << 17), 2)
    cases = {
        # Q18's semi join: ~60 runs padded to the build's shape bucket
        "q18_shape": (np.concatenate([q18, np.full(64 - len(q18), I64_MAX)]), q18_probes),
        "random_dups": (rng.integers(-500, 500, 4000) * 7919,
                        rng.integers(-800, 800, R) * 7919),
        "same_home_cluster": (np.arange(64) << 40, np.resize(np.arange(-8, 72) << 40, R)),
        "full_int64": (ext, np.resize(np.array([info.min, info.min + 2, -1, 0, 2, info.max,
                                                 info.max - 1, 7]), R)),
        "over_capacity": (rng.integers(0, 1 << 40, 1 << 19), rng.integers(0, 1 << 40, R)),
        # bucket 2^18, capacity 2^19: the largest build the table takes
        "largest_eligible": (dups, np.concatenate([rng.choice(dups, R // 2),
                                                   rng.integers(0, 1 << 40, R // 2)])),
        "ragged_r": (rng.integers(-500, 500, 4000) * 7919,
                     rng.integers(-800, 800, R + 37) * 7919),
        "all_miss": (np.arange(0, 4000, 2) << 20, np.resize(np.arange(1, 4001, 2) << 20, R)),
        "empty_sentinel": (np.array(pre + [5, 0x7FFFFFFF]),
                           np.resize(np.array(pre + [5, 6, 0x7FFFFFFF]), R)),
    }
    return {k: (np.sort(np.asarray(b, dtype=np.int64)), np.asarray(p, dtype=np.int64))
            for k, (b, p) in cases.items()}


def check_probe_case(torch, hp, sk, pr) -> dict:
    """B3 against its plain version and searchsorted on one case; raises
    on any difference. Returns what the case exercised."""
    ss_lo, ss_hi = hp.sorted_probe_ranges(sk, pr)
    ss_cnt = ss_hi - ss_lo
    cap = hp.table_capacity(sk.shape[0])
    if cap is None:
        # over capacity: the join keeps searchsorted and launches nothing
        n0 = hp.LAUNCHES["hash_probe"]
        lo, hi = hp.probe_ranges(sk, pr)
        if hp.LAUNCHES["hash_probe"] != n0 or not (
                torch.equal(lo, ss_lo) and torch.equal(hi, ss_hi)):
            raise AssertionError("an over-capacity build did not keep searchsorted")
        return {"cap": None, "placed": None, "hits": int((ss_cnt > 0).sum())}
    tkeys, tlos, this, placed = hp.build_table(sk, cap)
    lo, hi = hp.probe_table(tkeys, tlos, this, sk, pr)
    p_lo, p_hi = hp.plain_probe_table(tkeys, tlos, this, sk, pr)
    if not (torch.equal(lo, p_lo) and torch.equal(hi, p_hi)):
        bad = int(((lo != p_lo) | (hi != p_hi)).sum())
        raise AssertionError(f"hash_probe differs from its plain version on {bad} keys")
    placed = bool(placed)
    if placed:
        cnt = hi - lo
        hit = ss_cnt > 0
        if not (torch.equal(cnt, ss_cnt) and torch.equal(lo[hit], ss_lo[hit])):
            raise AssertionError("hash_probe ranges differ from searchsorted")
    else:  # the join falls back to searchsorted for such a build
        f_lo, f_hi = hp.probe_ranges(sk, pr)
        if not (torch.equal(f_lo, ss_lo) and torch.equal(f_hi, ss_hi)):
            raise AssertionError("an unplaced build did not fall back to searchsorted")
    return {"cap": cap, "placed": placed, "hits": int((ss_cnt > 0).sum())}


def phase_probe(torch, np, hp) -> dict:
    """Phase 1 for B3: every case of probe_cases on the card."""
    out = {}
    for name, (b, p) in probe_cases(np).items():
        sk = torch.from_numpy(b).cuda()
        pr = torch.from_numpy(p).cuda()
        out[name] = check_probe_case(torch, hp, sk, pr)
        torch.cuda.synchronize()
        log(f"hash_probe check {name}: R={len(p)} build={len(b)} {out[name]}: "
            f"bit-equal to the plain scan, counts equal searchsorted")
    return out


CHUNK_OUTPUTS = ("start", "count", "real_count", "cum", "total", "ok", "matched")


def probe_count_cases():
    """name -> (R, build length, options) of tidb_probe_count's phase-1
    cases: each route with and without the LEFT pad and in the flags-only
    mode, at Q1_ROWS rows and at a row count that is not a multiple of the
    kernel's 512-row tile; a table above the shared-memory limit (2^17
    build rows, capacity 2^18), a build holding the EMPTY-preimage keys,
    two-key range packing (with keys out of range), hash packing and a
    chunk smaller than one tile."""
    R = Q1_ROWS
    cases = {}
    for route in ("direct", "table", "sorted"):
        cases[route] = (R, 4096, {"route": route})
        cases[f"{route}_left"] = (R, 4096, {"route": route, "left_pad": True})
        cases[f"{route}_flags"] = (R, 4096, {"route": route, "flags_only": True})
        cases[f"{route}_ragged"] = (R + 37, 4096, {"route": route, "left_pad": True})
    cases.update({
        "table_cap_2e18": (R, 1 << 17, {"route": "table"}),
        "table_cap_2e18_flags": (R + 37, 1 << 17, {"route": "table", "flags_only": True}),
        "table_empty_preimage": (R, 64, {"route": "table", "preimage": True}),
        "two_key_direct": (R, 4096, {"route": "direct", "keys": 2}),
        "two_key_sorted": (R, 4096, {"route": "sorted", "keys": 2, "left_pad": True}),
        "two_key_table": (R, 4096, {"route": "table", "keys": 2}),
        "hash_table": (R, 4096, {"route": "table", "hash": True}),
        "hash_sorted": (R, 4096, {"route": "sorted", "hash": True, "left_pad": True}),
        "one_partial_tile": (100, 64, {"route": "table", "left_pad": True}),
    })
    return cases


def make_probe_count_case(torch, np, jk, hp, R, B, opts, seed, dev) -> dict:
    """The arguments of join_kernels.probe_count for one case, built on the
    CPU and moved to `dev`: a build of B sorted packed keys (an eighth of
    them dead INT64_MAX padding; two live INT64_MAX keys on the table and
    sorted routes) with its direct index or table, and R probe rows with
    NULL keys (5%), sel holes (15%), absent keys and INT64 extremes."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(np.int64)
    route, n_keys, hashed = opts["route"], opts.get("keys", 1), opts.get("hash", False)
    n = B - B // 8
    if hashed:
        build_cols = [rng.integers(-50, 50, n) * (1 << 40), rng.integers(0, 9, n) / 4.0]
        probe_cols = [rng.integers(-60, 60, R) * (1 << 40), rng.integers(0, 11, R) / 4.0]
    elif n_keys == 2:
        build_cols = [rng.integers(-20, 40, n), rng.integers(1000, 1100, n)]
        probe_cols = [rng.integers(-30, 50, R), rng.integers(990, 1110, R)]
    elif route == "direct":
        build_cols = [rng.integers(-1000, 2000, n)]
        probe_cols = [rng.integers(-1100, 2100, R)]
    else:
        build_cols = [np.resize(rng.integers(-(1 << 20), 1 << 20, (n + 1) // 2).repeat(2), n)
                      * 7919]
        build_cols[0][:2] = info.max  # legitimate INT64_MAX keys before the dead tail
        probe_cols = [rng.integers(-(1 << 20), 1 << 20, R) * 7919]
        hits = rng.random(R) < 0.4
        probe_cols[0][hits] = rng.choice(build_cols[0], int(hits.sum()))
    if opts.get("preimage"):
        pre = [empty_preimage(0), empty_preimage(FP_SALT)]
        build_cols[0][2:4] = pre
        probe_cols[0][rng.integers(0, R, R // 8)] = rng.choice(pre, R // 8)
    if n_keys == 1 and not hashed:
        ext = np.array([info.min, info.min + 1, -1, 0, info.max - 1, info.max])
        probe_cols[0][rng.integers(0, R, R // 50)] = rng.choice(ext, R // 50)
    modes = tuple("bits" if c.dtype.kind == "f" else "int" for c in build_cols)
    bk = [torch.from_numpy(np.ascontiguousarray(c)) for c in build_cols]
    if hashed:
        los = strides = rngs = [0] * n_keys
        packed = jk.hash_combine_device([jk.as_int64_key(k, m) for k, m in zip(bk, modes)])
    else:
        lo_hi = [(int(c.min()), int(c.max())) for c in build_cols]
        los = [lo for lo, _ in lo_hi]
        # as the join's pack info: a single key spanning (almost) all of
        # int64 gets range 0, "unknown" (its probe packer ignores ranges)
        rngs = [hi - lo + 1 if hi - lo + 1 < (1 << 63) else 0 for lo, hi in lo_hi]
        strides = [1] + [int(np.prod(rngs[:i])) for i in range(1, n_keys)]
        ones = torch.ones(n, dtype=torch.bool)
        packed, _, _ = jk.pack_keys(bk, (ones,) * n_keys, los, strides, rngs, ones, modes,
                                    False)
    sk = torch.cat([packed.sort().values, torch.full((B - n,), I64_MAX, dtype=torch.int64)])
    n_build = torch.tensor(n, dtype=torch.int64)
    firsts, lo_packed, rng_packed, table = torch.zeros(2, dtype=torch.int64), 0, 0, None
    if route == "direct":
        lo_packed = los[0] if n_keys == 1 else 0
        rng_packed = rngs[0] if n_keys == 1 else strides[-1] * rngs[-1]
        firsts = jk.build_direct_index(sk, n_build, lo_packed, jk.shape_bucket(rng_packed))
    elif route == "table":
        table = hp.placed_table(sk)
        if table is None:
            raise AssertionError("a phase-1 table left a run unplaced")
    kd = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in probe_cols)
    return {"sorted_keys": sk.to(dev), "n_build": n_build.to(dev), "key_datas": kd,
            "key_valids": tuple(torch.from_numpy(rng.random(R) < 0.95).to(dev) for _ in kd),
            "sel": torch.from_numpy(rng.random(R) < 0.85).to(dev), "los": los,
            "strides": strides, "rngs": rngs, "firsts": firsts.to(dev),
            "lo_packed": lo_packed, "rng_packed": rng_packed, "modes": modes,
            "hash_mode": hashed, "left_pad": opts.get("left_pad", False),
            "direct": route == "direct",
            "table": None if table is None else tuple(t.to(dev) for t in table),
            "flags_only": opts.get("flags_only", False)}


def chunk_args(jk, case: dict):
    """(positional, keyword) arguments of hash_probe.probe_chunk for a
    probe_count case: its keys packed as join_kernels.probe_count packs
    them."""
    packed, kvalid, in_range = jk._pack(
        case["key_datas"], case["key_valids"], case["los"], case["strides"], case["rngs"],
        case["sel"], case["modes"], case["hash_mode"])
    route = "direct" if case["direct"] else ("table" if case["table"] is not None else "sorted")
    kw = {"route": route, "firsts": case["firsts"], "lo_packed": case["lo_packed"],
          "rng_packed": case["rng_packed"], "table": case["table"],
          "left_pad": case["left_pad"], "flags_only": case["flags_only"]}
    return (packed, kvalid, in_range, case["sel"], case["n_build"], case["sorted_keys"]), kw


def check_chunk(torch, hp, args, kw) -> dict:
    """tidb_probe_count against plain_probe_chunk on the same card inputs;
    raises unless all seven outputs are bit-equal (the five scan outputs
    are None on both sides in the flags-only mode). Returns the launches
    made, the matched rows and the total."""
    n0 = hp.LAUNCHES["probe_count"]
    got = hp.probe_chunk(*args, **kw)
    launches = hp.LAUNCHES["probe_count"] - n0
    want = hp.plain_probe_chunk(*args, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(CHUNK_OUTPUTS, got, want):
        if (g is None) != (w is None) or (w is not None and not torch.equal(g, w)):
            bad = "one is None" if g is None or w is None else int((g != w).sum())
            raise AssertionError(f"probe_count {name} differs from plain ({bad})")
    return {"launches": launches, "matched": int(got[6].sum()),
            "total": None if got[4] is None else int(got[4])}


def phase_probe_count(torch, np, jk, hp) -> dict:
    """Phase 1 for tidb_probe_count: every case of probe_count_cases on the
    card, all seven outputs bit-equal to plain_probe_chunk, one launch
    each."""
    out = {}
    for i, (name, (R, B, opts)) in enumerate(probe_count_cases().items()):
        case = make_probe_count_case(torch, np, jk, hp, R, B, opts, 4000 + i, "cuda")
        args, kw = chunk_args(jk, case)
        out[name] = check_chunk(torch, hp, args, kw)
        if out[name]["launches"] != 1:
            raise AssertionError(f"probe_count {name}: {out[name]['launches']} launches")
        log(f"probe_count check {name}: R={R} build={B} {kw['route']} "
            f"left_pad={kw['left_pad']} flags_only={kw['flags_only']} {out[name]}: "
            f"bit-equal to plain")
    return out


# ---------------------------------------------------------------------------
# phase 2: Q1, Q6, Q3, Q5 and Q18 at SF1 through the port's Session
# ---------------------------------------------------------------------------


def _days(np, iso: str) -> int:
    return int((np.datetime64(iso) - np.datetime64("1970-01-01")).astype(np.int64))


def numpy_q1(np, t):
    n = t.n
    d = {c: t.data[c][:n] for c in ("l_quantity", "l_extendedprice", "l_discount",
                                    "l_tax", "l_shipdate", "l_returnflag",
                                    "l_linestatus")}
    m = d["l_shipdate"] <= _days(np, "1998-09-02")  # 1998-12-01 - 90 days
    rf_vals, ls_vals = t.dicts["l_returnflag"].values, t.dicts["l_linestatus"].values
    rows = []
    for rf in range(len(rf_vals)):
        for ls in range(len(ls_vals)):
            g = m & (d["l_returnflag"] == rf) & (d["l_linestatus"] == ls)
            cnt = int(g.sum())
            if not cnt:
                continue
            qty = d["l_quantity"][g]
            ext = d["l_extendedprice"][g]
            disc = d["l_discount"][g]
            tax = d["l_tax"][g]
            disc_price = ext * (100 - disc)                 # scale 4
            charge = disc_price * (100 + tax)               # scale 6
            rows.append((rf_vals[rf], ls_vals[ls], int(qty.sum()), int(ext.sum()),
                         int(disc_price.sum()), int(charge.sum()),
                         float(qty.sum()) / 100 / cnt, float(ext.sum()) / 100 / cnt,
                         float(disc.sum()) / 100 / cnt, cnt))
    return sorted(rows)


def numpy_q6(np, t):
    n = t.n
    ship = t.data["l_shipdate"][:n]
    disc = t.data["l_discount"][:n]
    m = ((ship >= _days(np, "1994-01-01")) & (ship < _days(np, "1995-01-01"))
         & (disc >= 5) & (disc <= 7) & (t.data["l_quantity"][:n] < 2400))
    return int((t.data["l_extendedprice"][:n][m] * disc[m]).sum())  # scale 4


def _scaled(s: str) -> int:
    """An exact decimal string -> its scaled integer ('12.50' -> 1250)."""
    return int(s.replace(".", ""))


def check_q1(np, got, want):
    if len(got) != len(want):
        raise AssertionError(f"Q1: {len(got)} rows, numpy has {len(want)}")
    for g, w in zip(got, want):
        if tuple(g[:2]) != w[:2] or g[9] != w[9]:
            raise AssertionError(f"Q1 keys/count differ: {g} vs {w}")
        if [_scaled(x) for x in g[2:6]] != list(w[2:6]):
            raise AssertionError(f"Q1 decimal sums differ: {g} vs {w}")
        for a, b in zip(g[6:9], w[6:9]):
            if not (np.isfinite(a) and abs(a - b) <= 1e-12 * abs(b)):
                raise AssertionError(f"Q1 averages differ: {g} vs {w}")


def _cols(t, *names):
    return [t.data[c][:t.n] for c in names]


def _iso(np, days: int) -> str:
    return str(np.datetime64("1970-01-01") + np.timedelta64(int(days), "D"))


def _lookup(np, keys, n_max):
    """key -> row position (-1 where absent) over keys in [0, n_max]."""
    pos = np.full(n_max + 1, -1, dtype=np.int64)
    pos[keys] = np.arange(len(keys))
    return pos


def _group_sum(np, keys, vals):
    """(sorted distinct keys, exact int64 sum of vals per key)."""
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(sums, inv, vals.astype(np.int64))
    return uniq, sums


def numpy_q3(np, cat):
    c, o, li = (cat.table("test", n) for n in ("customer", "orders", "lineitem"))
    d0 = _days(np, "1995-03-15")
    ckey, cseg = _cols(c, "c_custkey", "c_mktsegment")
    building = np.zeros(int(ckey.max()) + 1, dtype=bool)
    building[ckey[cseg == c.dicts["c_mktsegment"].values.index("BUILDING")]] = True
    okey, ocust, odate, oprio = _cols(o, "o_orderkey", "o_custkey", "o_orderdate",
                                      "o_shippriority")
    keep_o = (odate < d0) & building[ocust]
    opos = _lookup(np, okey, int(okey.max()))
    lkey, ship, ext, disc = _cols(li, "l_orderkey", "l_shipdate", "l_extendedprice",
                                  "l_discount")
    row = opos[lkey]
    m = (ship > d0) & (row >= 0) & keep_o[np.maximum(row, 0)]
    uniq, rev = _group_sum(np, lkey[m], ext[m] * (100 - disc[m]))  # scale 4
    od = odate[opos[uniq]]
    top = np.lexsort((od, -rev))[:10]
    return [(int(uniq[i]), int(rev[i]), _iso(np, od[i]), int(oprio[opos[uniq[i]]]))
            for i in top]


def numpy_q5(np, cat):
    c, o, li, su, na, re = (cat.table("test", n) for n in (
        "customer", "orders", "lineitem", "supplier", "nation", "region"))
    rkey, rname = _cols(re, "r_regionkey", "r_name")
    asia = rkey[rname == re.dicts["r_name"].values.index("ASIA")]
    nkey, nname, nreg = _cols(na, "n_nationkey", "n_name", "n_regionkey")
    in_asia = np.zeros(int(nkey.max()) + 1, dtype=bool)
    in_asia[nkey[np.isin(nreg, asia)]] = True
    ckey, cnat = _cols(c, "c_custkey", "c_nationkey")
    cnat_of = np.full(int(ckey.max()) + 1, -1)
    cnat_of[ckey] = cnat
    skey, snat = _cols(su, "s_suppkey", "s_nationkey")
    snat_of = np.full(int(skey.max()) + 1, -2)
    snat_of[skey] = snat
    okey, ocust, odate = _cols(o, "o_orderkey", "o_custkey", "o_orderdate")
    in_year = (odate >= _days(np, "1994-01-01")) & (odate < _days(np, "1995-01-01"))
    opos = _lookup(np, okey, int(okey.max()))
    lkey, lsupp, ext, disc = _cols(li, "l_orderkey", "l_suppkey", "l_extendedprice",
                                   "l_discount")
    row = np.maximum(opos[lkey], 0)
    sn = snat_of[lsupp]
    m = ((opos[lkey] >= 0) & in_year[row] & (cnat_of[ocust[row]] == sn)
         & in_asia[np.maximum(sn, 0)])
    nat, rev = _group_sum(np, sn[m], ext[m] * (100 - disc[m]))
    names = na.dicts["n_name"].values
    name_of = {int(k): names[int(n)] for k, n in zip(nkey, nname)}
    return sorted(((name_of[int(k)], int(v)) for k, v in zip(nat, rev)),
                  key=lambda r: -r[1])


def numpy_q18(np, cat, threshold=30000):
    """Q18's rows, and its semi join's sorted build keys (the orders whose
    quantity sum, at scale 2, exceeds the threshold)."""
    c, o, li = (cat.table("test", n) for n in ("customer", "orders", "lineitem"))
    lkey, qty = _cols(li, "l_orderkey", "l_quantity")
    uniq, tot = _group_sum(np, lkey, qty)
    big = uniq[tot > threshold]
    okey, ocust, odate, oprice = _cols(o, "o_orderkey", "o_custkey", "o_orderdate",
                                       "o_totalprice")
    opos = _lookup(np, okey, int(okey.max()))
    ckey, cname = _cols(c, "c_custkey", "c_name")
    cpos = _lookup(np, ckey, int(ckey.max()))
    names = c.dicts["c_name"].values
    rows = []
    for k, q in zip(big, tot[tot > threshold]):
        r = opos[k]
        if r < 0 or cpos[ocust[r]] < 0:
            continue
        rows.append((names[int(cname[cpos[ocust[r]]])], int(ocust[r]), int(k),
                     int(odate[r]), int(oprice[r]), int(q)))
    rows.sort(key=lambda r: (-r[4], r[3]))
    rows = [(a, b, k, _iso(np, d), p, q) for a, b, k, d, p, q in rows[:100]]
    return rows, np.sort(big.astype(np.int64))


def check_join_rows(qname, got, want, decimal_cols):
    """Port rows (decimal strings) against numpy rows (scaled ints)."""
    if len(got) != len(want):
        raise AssertionError(f"{qname}: {len(got)} rows, numpy has {len(want)}")
    for g, w in zip(got, want):
        g = tuple(_scaled(v) if i in decimal_cols else v for i, v in enumerate(g))
        if g != tuple(w):
            raise AssertionError(f"{qname} differs: {g} vs {w}")


def trace_summary(trace_path: str) -> tuple:
    """From a profiled run's chrome trace: the host->device copies by kind
    ({"pinned"/"pageable": {"count", "bytes", "device_us"}}; the profiler
    names each copy 'Memcpy HtoD (Pinned -> Device)' or '(Pageable ->
    Device)'), the device->host copies ("d2h", 'Memcpy DtoH ...'), and each
    host thread's busy time in torch operators and
    CUDA runtime calls (the union of their intervals, in us), which shows
    the prefetch thread beside the statement's own."""
    with open(trace_path) as f:
        trace = json.load(f)
    copies = {"pinned": {"count": 0, "bytes": 0, "device_us": 0.0},
              "pageable": {"count": 0, "bytes": 0, "device_us": 0.0},
              "d2h": {"count": 0, "bytes": 0, "device_us": 0.0}}
    spans = {}
    for e in trace.get("traceEvents", []):
        name, cat = e.get("name", ""), e.get("cat")
        if cat == "gpu_memcpy" and ("HtoD" in name or "DtoH" in name):
            kind = "d2h" if "DtoH" in name else "pinned" if "Pinned" in name else "pageable"
            copies[kind]["count"] += 1
            copies[kind]["bytes"] += int((e.get("args") or {}).get("bytes", 0))
            copies[kind]["device_us"] += float(e.get("dur", 0.0))
        elif cat in ("cpu_op", "cuda_runtime") and "dur" in e:
            ts = float(e["ts"])
            spans.setdefault(str(e.get("tid")), []).append((ts, ts + float(e["dur"])))
    busy = {}
    for tid, iv in spans.items():
        iv.sort()
        total, end = 0.0, None
        for a, b in iv:
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        busy[tid] = total
    return copies, busy


def profile_query(torch, session, sql: str) -> dict:
    """One warm run under torch.profiler: wall time, device busy time (the
    sum over the kernels and copies on the card), the idle share, the
    host->device copies split pinned/pageable (count, bytes), the host's
    cudaMemcpyAsync and launch counts, and the top entries by device and by
    host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.query(sql)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    trace_path = os.path.join(OUT_DIR, "profile_trace.tmp.json")
    prof.export_chrome_trace(trace_path)
    try:
        copies, thread_busy = trace_summary(trace_path)
    finally:
        os.remove(trace_path)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in on_card)
    host = [e for e in events if e.device_type == DeviceType.CPU]

    def row(e):
        return {"name": e.key, "count": e.count, "device_us": dev_us(e),
                "cpu_us": e.self_cpu_time_total}

    launch_apis = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                   "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
    copy_apis = ("cudaMemcpyAsync",)
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "idle_share": 1.0 - busy_us / wall_us,
            "host_launches": {e.key: e.count for e in host if e.key in launch_apis},
            "host_copies": {e.key: {"count": e.count, "cpu_us": e.self_cpu_time_total}
                            for e in host if e.key in copy_apis},
            "h2d": {k: copies[k] for k in ("pinned", "pageable")}, "d2h": copies["d2h"],
            "host_thread_busy_us": thread_busy,
            "top_device": [row(e) for e in sorted(on_card, key=dev_us, reverse=True)[:8]],
            "top_host": [row(e) for e in sorted(
                host, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]]}


def patch_builder(mod, name: str, wrap):
    """Replace the program builder `mod.<name>` by `wrap(real)` and empty
    the built-program cache (utils/jitcache.py), whose entries would
    otherwise serve programs built before the wrapper went in. Returns the
    function that puts the real builder back and empties the cache again,
    so that no wrapped program outlives its check."""
    from tidb_tpu_torch.utils import jitcache

    real = getattr(mod, name)
    setattr(mod, name, wrap(real))
    jitcache.clear()

    def restore():
        setattr(mod, name, real)
        jitcache.clear()

    return restore


def _bump(counter: list) -> None:
    counter[0] += 1


_SEG_CHUNKS = [0]  # count_segment_chunks' counter, its wrapper installed once


def count_segment_chunks() -> list:
    """Count the chunks the segment aggregation updates: the first call
    wraps the executor's make_segment_kernel (patch_builder, which empties
    the built-program cache, so every graph captured from then on holds
    the wrapper, whose count runs at each replay); every call sets the one
    counter to 0 and returns it."""
    from tidb_tpu_torch.executor import aggregate as agg_mod
    from tidb_tpu_torch.utils import dispatch

    if not getattr(agg_mod.make_segment_kernel, "_counts_chunks", False):
        def counting(real):
            def build(*args, **kw):
                init_state, update, G = real(*args, **kw)

                def counted(state, chunk):
                    # at each replay when a CUDA graph captures this update
                    dispatch.on_execute(_bump, _SEG_CHUNKS)
                    return update(state, chunk)

                return init_state, counted, G
            build._counts_chunks = True
            return build

        patch_builder(agg_mod, "make_segment_kernel", counting)
    _SEG_CHUNKS[0] = 0
    return _SEG_CHUNKS


def planned(s, sql: str):
    """The physical plan the session's next execution of `sql` takes: the
    planner with plan feedback's hints (as Session._plan_select plans) and
    the push-down decision Session._acquire_plan reads from the feedback
    store for the statement's digest. The launch checks hold each run to
    this plan, taken just before the run."""
    from tidb_tpu_torch.parser import parse
    from tidb_tpu_torch.planner import feedback as fb

    stmt = parse(sql)[0]
    apd = None
    if s._fb_enabled() and s._agg_push_down():
        if fb.STORE.apd_decision(s._stmt_digest(stmt, sql)[1]) is False:
            apd = False
    return s._plan_select(stmt, agg_push_down=apd)


def run_query(session, mods, sql: str):
    """One run with the kernels' launch counters, the join's probe-route
    counter and the pipeline's and segment store's counters zeroed just
    before and read just after, and the statement's sanctioned
    device->host fetches (dispatch.device_get, "device_get"); returns
    (rows, counts, seconds)."""
    from tidb_tpu_torch.utils import dispatch, jitcache

    seg_mod, hp, jk, pl, st, agg_mod = mods
    seg_mod.reset_launches()
    hp.reset_launches()
    jk.reset_routes()
    pl.reset_counters()
    agg_mod.reset_counters()
    jitcache.reset_runs()
    seg0 = dict(st.SCAN_SEGMENTS_TOTAL)
    f0 = dispatch.fetch_count()
    t0 = time.perf_counter()
    rows = session.query(sql)
    dt = time.perf_counter() - t0
    fetches = dispatch.fetch_count() - f0
    pre = dict(pl.PIPELINE_PREFETCH_TOTAL)
    counts = {"launches": {**seg_mod.LAUNCHES, **hp.LAUNCHES},
              "routes": dict(jk.PROBE_ROUTES),
              "segments": {k: st.SCAN_SEGMENTS_TOTAL[k] - seg0[k] for k in seg0},
              "staged_batches": pre["hit"] + pre["wait"] + pre["inline"],
              "prefetch": pre, "h2d": dict(pl.PIPELINE_PREFETCH_BYTES),
              "stage_s": dict(pl.PIPELINE_STAGE_SECONDS),
              "cache": dict(pl.DEVICE_CACHE_TOTAL),
              "fused": dict(pl.PIPELINE_FUSED_TOTAL),
              "generic_runs": dict(agg_mod.DEVICE_GENERIC_TOTAL),
              "device_get": fetches, "programs": jitcache.runs()}
    return rows, counts, dt


def fusible_joins(plan) -> int:
    """Inner/LEFT hash joins of a physical plan whose probe side peels to a
    plain table scan: the joins the builder's gates send to
    FusedScanProbeExec."""
    from tidb_tpu_torch.executor.builder import peel_stages
    from tidb_tpu_torch.planner.physical import PHashJoin, PScan

    n, stack = 0, [plan]
    while stack:
        node = stack.pop()
        stack.extend(node.children)
        if (isinstance(node, PHashJoin) and node.kind in ("inner", "left")
                and node.other_cond is None and not node.exists_sem):
            _stages, base = peel_stages(node.children[1 - node.build_side])
            n += type(base) is PScan and base.table is not None
    return n


def frags(agg=0, generic=0, probe=0, topn=0, generic_classic=0) -> dict:
    """Fragments a run must take: fused segment ("agg") and generic
    aggregations, probes and top-k roots, and generic aggregations on the
    classic tree's device path ("generic_classic")."""
    return {"agg": agg, "generic": generic, "probe": probe, "topn": topn,
            "generic_classic": generic_classic}


def plan_fragments(plan, capacity: int) -> dict:
    """The fragments a physical plan calls for under the builder's gates and
    the device engine: an aggregation over a plain scan runs fused (segment
    or, for core generic functions, generic); other core generic
    aggregations take the classic tree's device path; fusible joins probe
    fused; an ORDER BY [LIMIT] over a plain scan whose state fits the chunk
    capacity runs as a fused top-k."""
    from tidb_tpu_torch.executor.builder import peel_stages
    from tidb_tpu_torch.planner.logical import core_generic_agg
    from tidb_tpu_torch.planner.physical import PHashAgg, PScan, PSort, PTopN

    out = frags(probe=fusible_joins(plan))
    stack = [plan]
    while stack:
        node = stack.pop()
        stack.extend(node.children)
        if not node.children:
            continue
        _stages, base = peel_stages(node.children[0])
        scan = type(base) is PScan and base.table is not None
        if isinstance(node, PHashAgg):
            if node.strategy == "segment":
                out["agg"] += scan
            elif core_generic_agg(node.group_exprs, node.aggs):
                out["generic" if scan else "generic_classic"] += 1
        elif isinstance(node, (PTopN, PSort)) and node.items and scan:
            k = node.count + node.offset if isinstance(node, PTopN) else base.table.n
            out["topn"] += k <= capacity
    return out


def check_path(qname, c, agg_chunks, want: dict):
    """The launch contract of one query's run on one path: tidb_segagg once
    per aggregated chunk (one-column entries never), tidb_probe_count once
    per probe chunk (lookup-only never), and the fused fragments and device
    generic aggregations the plan calls for (`want`, from plan_fragments)."""
    lc = c["launches"]
    if lc["segagg"] != agg_chunks:
        raise AssertionError(f"{qname}: segagg launched {lc['segagg']} times over "
                             f"{agg_chunks} aggregated chunks, not once per chunk")
    if lc["segsum_count"] or lc["segsum_i64"] or lc["hash_probe"]:
        raise AssertionError(f"{qname} launched an off-path kernel entry: {lc}")
    if lc["probe_count"] != sum(c["routes"].values()):
        raise AssertionError(f"{qname}: probe_count launched {lc['probe_count']} times "
                             f"over {c['routes']} probe chunks, not once per chunk")
    got = {k: c["fused"][k] for k in ("agg", "generic", "probe", "topn")}
    got["generic_classic"] = c["generic_runs"]["classic"]
    if c["generic_runs"]["fused"] != c["fused"]["generic"] or got != want:
        raise AssertionError(f"{qname}: fragments {c['fused']}, device generic runs "
                             f"{c['generic_runs']}; the plan calls for {want}")


def packed_batch_phase(torch, np, Session, mods, agg_chunks) -> dict:
    """A 1,200,000-row table loaded with tidb_tpu_segment_rows = 8192
    before its first scan, so the fused scan packs k = 65,536 / 8,192 = 8
    segments a batch: one aggregate and one join over it, each equal to
    numpy, each through its fused executor, tidb_segagg once per staged
    batch."""
    n, nd = 1_200_000, 100_000
    rng = np.random.default_rng(5)
    k = rng.integers(0, 2 * nd, n).astype(np.int64)  # half the keys miss
    cvals = ["AIR", "MAIL", "RAIL", "SHIP", "TRUCK"]
    c = rng.integers(0, len(cvals), n)
    v = rng.integers(-100_000, 10_000_000, n).astype(np.int64)  # decimal(12,2)
    w = rng.integers(0, 1000, nd).astype(np.int64)
    s = Session()
    s.execute("set tidb_tpu_segment_rows = 8192")
    s.execute("create table big (k bigint, c varchar(8), v decimal(12,2))")
    s.execute("create table dim (k bigint, w bigint)")
    s.catalog.table("test", "big").insert_columns(
        {"k": k, "v": v}, strings={"c": [cvals[i] for i in c]})
    s.catalog.table("test", "dim").insert_columns({"k": np.arange(nd), "w": w})
    out = {}
    agg_sql = "select c, count(*), sum(v) from big where v > 0 group by c order by c"
    agg_chunks[0] = 0
    rows, cnt, dt = run_query(s, mods, agg_sql)
    m = v > 0
    want = [(cvals[i], int((m & (c == i)).sum()), int(v[m & (c == i)].sum()))
            for i in range(len(cvals))]
    got = [(r[0], r[1], _scaled(r[2])) for r in rows]
    if got != want:
        raise AssertionError(f"packed aggregate {got} vs numpy {want}")
    n_segs = -(-n // 8192)
    if cnt["segments"]["scanned"] + cnt["segments"]["pruned"] != n_segs:
        raise AssertionError(f"packed aggregate read segments {cnt['segments']}")
    check_path("packed_agg", cnt, agg_chunks[0], frags(agg=1))
    if agg_chunks[0] != cnt["staged_batches"] or cnt["staged_batches"] != -(-n_segs // 8):
        raise AssertionError(f"packed aggregate: {cnt['staged_batches']} staged batches, "
                             f"{agg_chunks[0]} aggregated, {n_segs} segments")
    out["agg"] = {"counts": cnt, "seconds": dt}
    join_sql = ("select count(*), sum(dim.w), sum(big.v) from big join dim "
                "on big.k = dim.k where big.c <> 'RAIL'")
    from tidb_tpu_torch.planner.physical import explain_text

    plan = planned(s, join_sql)
    agg_chunks[0] = 0
    rows, cnt, dt = run_query(s, mods, join_sql)
    hit = (k < nd) & (c != cvals.index("RAIL"))
    want = (int(hit.sum()), int(w[k[hit]].sum()), int(v[hit].sum()))
    got = (rows[0][0], int(rows[0][1]), _scaled(rows[0][2]))
    if got != want:
        raise AssertionError(f"packed join {got} vs numpy {want}")
    check_path("packed_join", cnt, agg_chunks[0], frags(probe=fusible_joins(plan)))
    if cnt["fused"]["probe"] != 1:
        raise AssertionError(f"the packed join did not run fused: {cnt['fused']}")
    out["join"] = {"counts": cnt, "seconds": dt, "plan": explain_text(plan)}
    log(f"packed batches (1,200,000 rows, 8,192-row segments, 8 a batch): aggregate "
        f"{cnt['staged_batches']} staged batches; both equal numpy; counts "
        f"{out['agg']['counts']} / {cnt}")
    return out


def probe_slot_reads(torch, hp, tkeys, tlos, sk, probes):
    """(slots read, distinct bytes read) of B3's scan for these probes: up
    to and including the first hit or EMPTY slot, at most MAX_PROBES (the
    work its early stop leaves); the bytes are the distinct 12-byte slots
    and 8-byte sorted keys verified, each counted once."""
    cap = tkeys.shape[0]
    home = hp._mix32(probes) & (cap - 1)
    fp = hp._mix32(probes, FP_SALT)
    done = torch.zeros(probes.shape, dtype=torch.bool, device=probes.device)
    slots, verified, reads = [], [], 0
    for r in range(hp.MAX_PROBES):
        pos = (home + r) & (cap - 1)
        act = ~done
        reads += int(act.sum())
        slots.append(pos[act])
        k = tkeys[pos].long()
        cand = tlos[pos].long().clamp(0, sk.shape[0] - 1)
        fpm = act & (k == fp)
        verified.append(cand[fpm])
        done |= (k == 0x7FFFFFFF) | (fpm & (sk[cand] == probes))
    return reads, (torch.unique(torch.cat(slots)).numel() * 12
                   + torch.unique(torch.cat(verified)).numel() * 8)


_PROBE_RECS: list = []  # record_probe_chunks' open records


def _count_probe_call(route: str, mode: str, build: int) -> None:
    for rec in _PROBE_RECS:
        key = (rec["query"], route, mode, build)
        rec["calls"][key] = rec["calls"].get(key, 0) + 1


def install_probe_wrapper(hp) -> None:
    """Wrap hash_probe.probe_chunk once, before any CUDA graph is captured
    (a graph replays the function it captured: the first install empties
    the built-program cache). Each call counts into every open
    record_probe_chunks record, at each replay when a graph captured it,
    and an eager call's arguments go to the open records that keep them."""
    from tidb_tpu_torch.utils import dispatch, jitcache

    if getattr(hp.probe_chunk, "_records", False):
        return
    real = hp.probe_chunk

    def recording(*args, **kw):
        mode = "flags" if kw.get("flags_only") else "full"
        build = args[5].shape[0]
        if not dispatch.capturing():
            for rec in _PROBE_RECS:
                if rec["keep_args"]:
                    rec["args"].setdefault((rec["query"], kw["route"], mode, build), (args, kw))
        dispatch.on_execute(_count_probe_call, kw["route"], mode, build)
        return real(*args, **kw)

    recording._records = True
    jitcache.clear()
    hp.probe_chunk = recording


def record_probe_chunks(hp, args: bool = False) -> dict:
    """Open a record of hash_probe.probe_chunk's calls: per (query, route,
    mode, build rows) the kernel calls made (replays included), and with
    `args` (a caller that reads them) an eager call's arguments; the
    built-program cache is then emptied, so every statement warms up
    eagerly (a capture's arguments are the graph's own buffers). The
    caller sets rec["query"] before each query and closes the record with
    stop_recording(rec); recorded_modes(rec) gives its calls by route and
    mode."""
    from tidb_tpu_torch.utils import jitcache

    install_probe_wrapper(hp)
    if args:
        jitcache.clear()
    rec = {"query": None, "calls": {}, "args": {}, "keep_args": args}
    _PROBE_RECS.append(rec)
    return rec


def stop_recording(rec: dict) -> None:
    if rec in _PROBE_RECS:
        _PROBE_RECS.remove(rec)


def recorded_modes(rec: dict) -> dict:
    """tidb_probe_count's launches by "route/mode" in the record `rec`."""
    modes = {}
    for (_q, route, mode, _b), n in rec["calls"].items():
        modes[f"{route}/{mode}"] = modes.get(f"{route}/{mode}", 0) + n
    return modes


def with_probe_modes(hp, run) -> dict:
    """Run a phase with its probe_count calls recorded; its report gains
    "probe_modes": calls by route and mode ("direct/full", ...)."""
    probes = record_probe_chunks(hp)
    try:
        report = run()
    finally:
        stop_recording(probes)
    report["probe_modes"] = recorded_modes(probes)
    return report


def main_path_args(rec, query: str, route: str, mode: str):
    """The recorded arguments of the build `query` probed most often along
    `route` in `mode` ('full' or 'flags'); of another query's build when
    this plan sent `query` elsewhere; None when no query took the route."""
    keys = [k for k in rec["calls"] if k[:3] == (query, route, mode) and k in rec["args"]]
    if not keys:
        keys = [k for k in rec["calls"] if k[1:3] == (route, mode) and k in rec["args"]]
    if not keys:
        return None
    return rec["args"][max(keys, key=rec["calls"].get)]


def chunk_lookup_work(torch, hp, args, kw):
    """(distinct bytes of the lookup structure read, operations) of one
    probe_chunk call on these inputs: the direct index's entries, the
    table's slots and verified sorted keys, or the sorted keys a search
    visits, each counted once; operations per row for the lookup and the
    count, pad and scan (about 6)."""
    packed, _kvalid, _in_range, _sel, _n_build, sk = args
    R = packed.shape[0]
    if kw["route"] == "direct":
        idxc = (packed - kw["lo_packed"]).clamp(0, kw["firsts"].shape[0] - 2)
        read = torch.unique(torch.cat([idxc, idxc + 1])).numel() * 8
        return read, R * (8 + 6)
    if kw["route"] == "table":
        reads, read = probe_slot_reads(torch, hp, kw["table"][0], kw["table"][1], sk, packed)
        return read, R * (MIX_OPS + 6) + reads * SLOT_OPS
    n = sk.shape[0]
    bl = torch.zeros(R, dtype=torch.int64, device=packed.device)
    bu = torch.zeros_like(bl)
    visited, levels = [], 0
    while n > 1:
        half = n >> 1
        visited += [bl + half, bu + half]
        bl = torch.where(sk[bl + half] < packed, bl + half, bl)
        bu = torch.where(sk[bu + half] <= packed, bu + half, bu)
        n -= half
        levels += 1
    visited += [bl, bu]
    return torch.unique(torch.cat(visited)).numel() * 8, R * (2 * (levels + 1) * 3 + 6)


def probe_chunk_row(torch, hp, name: str, args, kw, launches: int, calls: int = 20,
                    reps: int = 10) -> dict:
    """The kernels-line row of tidb_probe_count on one shape: checked
    bit-equal first, then its graph-replayed time beside the eager chain
    it replaces (the earlier eager composition: the all-true in-range mask, B3's
    lookup on the table route, count, pad and cumsum, always in full),
    the plain version (a loop), searchsorted x2 and its bound."""
    packed, kvalid, in_range, sel, n_build, sk = args
    check_chunk(torch, hp, args, kw)
    R = packed.shape[0]
    timing = {"calls": calls, "reps": reps}
    ms = device_ms(torch, lambda: hp.probe_chunk(*args, **kw), graph=True, **timing)
    chain_kw = dict(kw, flags_only=False, lookup=hp.probe_table)
    chain_ms = device_ms(torch, lambda: hp.plain_probe_chunk(
        packed, kvalid, torch.ones_like(sel) if in_range is None else in_range, sel,
        n_build, sk, **chain_kw), graph=True, **timing)
    plain_ms = device_ms(torch, lambda: hp.plain_probe_chunk(*args, **kw), graph=False,
                         **timing)
    library_ms = device_ms(torch, lambda: (torch.searchsorted(sk, packed),
                                           torch.searchsorted(sk, packed, right=True)),
                           graph=True, **timing)
    read, ops = chunk_lookup_work(torch, hp, args, kw)
    # keys, key validity, sel (and in-range) in; ok and matched out, and in
    # full mode start, count, real_count and cum and the total
    flags_only = kw.get("flags_only", False)
    row_bytes = 10 + (in_range is not None) + (2 if flags_only else 34)
    nbytes = R * row_bytes + read + (0 if flags_only else 8)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    row = {"name": name, "route": "cuda", "source": "tidb_tpu_torch/ops/csrc/hash_probe.cu",
           "replaces": "tidb_tpu/ops/hash_probe.py:244",
           "also_replaces": "tidb_tpu/ops/join_kernels.py:311",
           "launches": launches, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms, "replaced_chain_ms": chain_ms}
    log(f"{name} at R={R} build={sk.shape[0]} ({kw['route']}, flags_only="
        f"{flags_only}, left_pad={kw.get('left_pad', False)}): {ms * 1e3:.2f} us/call, bound "
        f"{row['bound_ms'] * 1e3:.3f} us ({nbytes} B, {row_bytes} B/row), the eager chain "
        f"it replaces {chain_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
        f"searchsorted x2 {library_ms * 1e3:.2f} us; {launches} launches on its path")
    return row


def phase_paths(torch, np, s, mods, new_session, queries) -> dict:
    """Phase 2 on a Session `s` holding the TPC-H tables: the fused path
    (default sysvars), the classic raw path, and packed batches over a
    table of `new_session()`; every result against numpy, every launch
    contract checked. Returns what phases 3 and the report read."""
    from tidb_tpu_torch.planner.physical import explain_text
    from tidb_tpu_torch.storage.tpch_queries import Q

    seg_mod, hp, jk, pl, st, agg_mod = mods
    li = s.catalog.table("test", "lineitem")
    n_rows = li.live_rows
    agg_chunks = count_segment_chunks()
    plans = {}

    # the default sysvars: the columnar segment store and the fused
    # pipelines. The first runs of Q1 and Q6 build the segment stores and
    # fill the device buffer cache; their second runs stage nothing
    results, per_query, cold = {}, {}, {}
    probes = record_probe_chunks(hp, args=True)
    for run in ("q1", "q1_warm", "q6", "q6_warm", "q3", "q5", "q18"):
        qname = run.split("_")[0]
        # the plan this run executes: segment stores built by earlier runs
        # feed the planner's statistics, so it is taken just before
        plans[qname] = planned(s, Q[qname][0])
        want = plan_fragments(plans[qname], s._plan_capacity(plans[qname]))
        if qname in ("q1", "q6") and want["agg"] != 1:
            raise AssertionError(f"{qname}'s plan has no fused segment aggregation")
        if qname in ("q3", "q18") and not want["generic"] + want["generic_classic"]:
            raise AssertionError(f"{qname}'s plan has no device generic aggregation")
        if qname == "q18" and not want["generic"]:
            raise AssertionError("q18's IN subquery is not a fused generic aggregation")
        agg_chunks[0] = 0
        probes["query"] = qname
        rows, cnt, dt = run_query(s, mods, Q[qname][0])
        cnt["aggregated_chunks"] = agg_chunks[0]
        per_query[run] = cnt
        if run == qname:
            results[qname], cold[qname] = rows, dt
        elif rows != results[qname]:
            raise AssertionError(f"{run} differs from the first run")
        log(f"{run} (fused): {dt:.3f} s; {cnt['device_get']} device_get; launches {cnt['launches']}; probe routes "
            f"{cnt['routes']}; segments scanned/pruned {cnt['segments']}; staged "
            f"batches {cnt['staged_batches']}; prefetch {cnt['prefetch']}; host->device "
            f"{cnt['h2d']}; staging host s {cnt['stage_s']}; device buffer cache {cnt['cache']}; fused {cnt['fused']}; "
            f"aggregated chunks {agg_chunks[0]}; device generic runs {cnt['generic_runs']}")
        check_path(run, cnt, agg_chunks[0], want)
        cnt["want"] = want
    stop_recording(probes)
    for q in ("q1", "q6"):
        cold_c, warm_c = per_query[q], per_query[q + "_warm"]
        if not (cold_c["staged_batches"] == cold_c["aggregated_chunks"]
                == cold_c["h2d"]["copies"] > 0 and cold_c["h2d"]["h2d"] > 0):
            raise AssertionError(f"{q}: staging {cold_c}, not one pinned copy a batch")
        if warm_c["h2d"]["h2d"] or warm_c["staged_batches"] or warm_c["cache"]["hit"] < 1:
            raise AssertionError(f"{q}'s second run staged: {warm_c}")
        if warm_c["aggregated_chunks"] != cold_c["aggregated_chunks"]:
            raise AssertionError(f"{q}'s second run aggregated another batch count")
    if per_query["q18"]["routes"]["table"] <= 0:
        log("note: q18 made no table-route probe at SF1 under this plan")
    # (route, mode) -> kernel launches over the five queries
    probe_modes = recorded_modes(probes)
    log(f"probe_count launches by route and mode: {probe_modes}")

    def check_results(res, label):
        check_q1(np, res["q1"], numpy_q1(np, li))
        if len(res["q6"]) != 1 or _scaled(res["q6"][0][0]) != numpy_q6(np, li):
            raise AssertionError(f"{label} Q6 {res['q6']} vs numpy {numpy_q6(np, li)}")
        check_join_rows("q3", res["q3"], numpy_q3(np, s.catalog), {1})
        check_join_rows("q5", res["q5"], numpy_q5(np, s.catalog), {1})
        check_join_rows("q18", res["q18"], q18_want, {4, 5})
        if not res["q3"] or not res["q5"] or not res["q18"]:
            raise AssertionError(f"{label}: a join query returned no rows")

    q18_want, q18_build = numpy_q18(np, s.catalog)
    check_results(results, "fused")
    log(f"fused path: Q1 ({len(results['q1'])} groups), Q6, Q3 ({len(results['q3'])} "
        f"rows), Q5 ({len(results['q5'])}) and Q18 ({len(results['q18'])}) equal the "
        f"numpy evaluation")
    launches = {k: sum(per_query[r]["launches"][k] for r in per_query)
                for k in ("segagg", "segsum_count", "segsum_i64", "hash_probe",
                          "probe_count")}

    # the earlier path: no segment store, no fused pipeline (the raw
    # classic tree), the same queries and the same launch contract
    s.execute("set tidb_tpu_pipeline_fuse = 0")
    s.execute("set tidb_tpu_columnar_enable = 0")
    classic, classic_counts = {}, {}
    for qname in queries:
        agg_chunks[0] = 0
        # its own plan, taken just before: plan feedback may have moved it
        # since the fused run (the push-down exploration, join hints)
        plan = planned(s, Q[qname][0])
        want = plan_fragments(plan, s._plan_capacity(plan))
        rows, cnt, dt = run_query(s, mods, Q[qname][0])
        cnt["aggregated_chunks"] = agg_chunks[0]
        classic[qname], classic_counts[qname] = rows, cnt
        log(f"{qname} (classic): {dt:.3f} s; launches {cnt['launches']}; probe routes "
            f"{cnt['routes']}; fused {cnt['fused']}; aggregated chunks {agg_chunks[0]}; "
            f"device generic runs {cnt['generic_runs']}")
        check_path(qname, cnt, agg_chunks[0],
                   frags(generic_classic=want["generic"] + want["generic_classic"]))
        if cnt["segments"]["scanned"] or cnt["staged_batches"]:
            raise AssertionError(f"{qname} (classic) read the segment store: {cnt}")
    check_results(classic, "classic")
    for qname in queries:
        if classic[qname] != results[qname]:
            raise AssertionError(f"{qname}: the classic path's rows differ from the fused path's")
    s.execute("set tidb_tpu_pipeline_fuse = 1")
    s.execute("set tidb_tpu_columnar_enable = 1")
    launches_classic = {k: sum(classic_counts[q]["launches"][k] for q in queries)
                        for k in launches}
    log("classic path: the same rows as the fused path and numpy")

    packed = packed_batch_phase(torch, np, new_session, mods, agg_chunks)
    launches_packed = {k: packed["agg"]["counts"]["launches"][k]
                       + packed["join"]["counts"]["launches"][k] for k in launches}
    plans = {q: explain_text(plans[q]) for q in queries}
    for qname in ("q3", "q5", "q18"):
        log(f"{qname} plan at SF1:\n{plans[qname]}")

    return {"li": li, "n_rows": n_rows, "results": results, "per_query": per_query,
            "cold": cold, "probes": probes, "probe_modes": probe_modes,
            "launches": launches, "launches_classic": launches_classic,
            "launches_packed": launches_packed, "classic_counts": classic_counts,
            "packed": packed, "plans": plans, "q18_build": q18_build}



# queries phase 3 times but does not profile in a mode: the profiler adds
# 20-40 s to each run of Q5 and Q18 (tens of thousands of launches), and
# the classic mode's findings (the raw path's copies) are read from Q1,
# Q6 and Q3 (the classic Q5 and Q18 profiles were cut when the mesh
# phase took its share of the script's time limit)
UNPROFILED = {"fused_cache": ("q1", "q6", "q3", "q5", "q18"),
              "fused_nocache": ("q1", "q6", "q3", "q5"),
              "fused_nocache_inline": ("q1", "q6", "q3", "q5"),
              "classic": ("q1", "q6", "q3", "q5"),
              "generic_host": ("q3",)}
# (to make room for the DCN phase inside the time limit:
# fused_cache no longer profiles Q18, whose profiled run took 39 s at
# SF1; the two cache-off modes profile nothing; Q18 runs in fused_cache
# alone, the host engine runs Q3 alone. Since the graphs step, which
# profiles the default path by replay, fused_cache is not run here, and
# classic profiles Q1 alone, cuts for the script's time limit; since the
# SF10 phase neither classic Q1 nor the host engine's Q3 is profiled)
# the stats phase's queries left unprofiled: at SF1 on an H100 (700 W)
# Q18's profiled run took 59.9 s and Q5's 21.0 s, and phase 3 profiles
# both already
STATS_UNPROFILED = ("q1", "q3", "q5", "q18")  # Q1 and Q3 too since the DCN phase


def phase_modes(torch, s, queries, n_rows, fused_cache_s=None) -> tuple:
    """Phase 3's query times: warm medians of 3 and one profiled warm run of
    each query in each mode. With `fused_cache_s` ({query: s}, the graphs
    step's replay medians of the same default path) fused_cache is not run
    again. Returns (times, profiles)."""
    from tidb_tpu_torch.executor import pipeline as pl
    from tidb_tpu_torch.storage.tpch_queries import Q

    # five modes: fused with the device buffer cache (the default), fused
    # with the cache budget 0 (every run stages through the prefetcher),
    # the same staged inline at prefetch depth 0 (what the staging thread
    # buys or costs against the host's Python launch loop), the classic
    # raw path, and for the generic aggregations of Q3 and Q18 the host
    # engine (tidb_device_engine_mode = 'off': the numpy groupby, classic
    # joins)
    modes = {"fused_cache": [],
             "fused_nocache": ["set global tidb_tpu_device_buffer_cache_bytes = 0"],
             "fused_nocache_inline": ["set global tidb_tpu_device_buffer_cache_bytes = 0",
                                      "set tidb_tpu_pipeline_prefetch_depth = 0"],
             "classic": ["set tidb_tpu_pipeline_fuse = 0",
                         "set tidb_tpu_columnar_enable = 0"],
             "generic_host": ["set tidb_device_engine_mode = 'off'"]}
    undo = ["set global tidb_tpu_device_buffer_cache_bytes = 268435456",
            "set tidb_tpu_pipeline_prefetch_depth = 2",
            "set tidb_tpu_pipeline_fuse = 1", "set tidb_tpu_columnar_enable = 1",
            "set tidb_device_engine_mode = 'auto'"]
    times, profiles = {}, {}
    for mode, sets in modes.items():
        for stmt in sets:
            s.execute(stmt)
        times[mode], profiles[mode] = {}, {}
        if mode == "fused_cache" and fused_cache_s is not None:
            times[mode] = dict(fused_cache_s)
            log(f"{mode}: the graphs step's replay medians, ms "
                f"{ {q: round(v * 1e3, 3) for q, v in fused_cache_s.items()} }")
            continue
        for qname in queries:
            if mode == "generic_host" and qname != "q3" \
                    or mode != "fused_cache" and qname == "q18":
                continue
            runs = []
            for _ in range(WARM_RUNS):
                t0 = time.perf_counter()
                s.query(Q[qname][0])
                runs.append(time.perf_counter() - t0)
            med = statistics.median(runs)
            times[mode][qname] = med
            if qname in UNPROFILED.get(mode, ()):
                log(f"{mode} {qname}: warm wall median of {WARM_RUNS} {med * 1e3:.3f} ms; runs {runs}")
                continue
            pl.reset_counters()
            prof = profile_query(torch, s, Q[qname][0])
            prof["pipeline"] = {"prefetch": dict(pl.PIPELINE_PREFETCH_TOTAL),
                                "stage_s": dict(pl.PIPELINE_STAGE_SECONDS),
                                "cache": dict(pl.DEVICE_CACHE_TOTAL)}
            profiles[mode][qname] = prof
            log(f"{mode} {qname}: warm wall median of {WARM_RUNS} {med * 1e3:.3f} ms "
                f"({n_rows / med:,.0f} rows/s over {n_rows} lineitem rows); runs {runs}; "
                f"profiled wall {prof['wall_us'] / 1e3:.3f} ms, device busy "
                f"{prof['device_busy_us'] / 1e3:.3f} ms, idle share "
                f"{prof['idle_share']:.3f}, host->device {prof['h2d']}, device->host "
                f"{prof['d2h']}, host "
                f"{prof['host_copies']} {prof['host_launches']}; pipeline {prof['pipeline']}; "
                f"host thread busy ms "
                f"{ {t: round(v / 1e3, 1) for t, v in prof['host_thread_busy_us'].items()} }")
            for e in prof["top_device"][:5] + prof["top_host"][:5]:
                log(f"  {e['name'][:60]:60s} device {e['device_us'] / 1e3:9.3f} ms "
                    f"x{e['count']}  host {e['cpu_us'] / 1e3:9.3f} ms")
        for stmt in undo:
            s.execute(stmt)
    return times, profiles



# ---------------------------------------------------------------------------
# the 22 TPC-H queries at SF0.1 against an indexed sqlite oracle
# ---------------------------------------------------------------------------

GENERIC_QUERIES = ("q2", "q3", "q7", "q8", "q9", "q10", "q11", "q13", "q15", "q16", "q17",
                   "q18", "q20")
FUSED_GENERIC_QUERIES = ("q15", "q17", "q18", "q20")


def sqlite_oracle(np, catalog, db: str = "test"):
    """The port's tables copied into an in-memory sqlite database, with the
    key indexes a TPC-H grid needs (what tidb_tpu/testutil.py's
    mirror_to_sqlite and index_tpch_oracle do): decimals become REAL,
    dates ISO strings, strings their dictionary values, case-insensitive
    collations NOCASE."""
    import sqlite3

    from tidb_tpu_torch.types import TypeKind

    sql_type = {TypeKind.INT: "INTEGER", TypeKind.BOOL: "INTEGER", TypeKind.FLOAT: "REAL",
                TypeKind.DECIMAL: "REAL", TypeKind.STRING: "TEXT", TypeKind.DATE: "TEXT"}
    conn = sqlite3.connect(":memory:")
    for name in catalog.tables(db):
        t = catalog.table(db, name)
        cols = t.schema.columns
        decls = ", ".join(
            f"{c.name} {sql_type[c.type_.kind]}"
            + (" COLLATE NOCASE" if c.type_.kind == TypeKind.STRING
               and c.coll.endswith("_ci") else "") for c in cols)
        conn.execute(f"CREATE TABLE {name} ({decls})")
        n = t.n
        if n == 0:
            continue
        pycols = []
        for c in cols:
            data, valid, k = t.data[c.name][:n], t.valid[c.name][:n], c.type_.kind
            if k == TypeKind.STRING:
                vals = np.asarray(t.dicts[c.name].values, dtype=object)[np.maximum(data, 0)]
            elif k == TypeKind.DECIMAL:
                vals = (data.astype(np.float64) / 10 ** c.type_.scale).astype(object)
            elif k == TypeKind.DATE:
                vals = (np.datetime64("1970-01-01", "D")
                        + data.astype("timedelta64[D]")).astype(str).astype(object)
            elif k == TypeKind.FLOAT:
                vals = data.astype(np.float64).astype(object)
            else:
                vals = data.astype(np.int64).astype(object)
            vals[~valid] = None
            pycols.append(vals.tolist())
        live = t.live_mask(0, n)
        rows = [r for r, ok in zip(zip(*pycols), live) if ok]
        conn.executemany(f"INSERT INTO {name} VALUES ({', '.join('?' * len(cols))})", rows)
    for ddl in ("create index li_ok on lineitem(l_orderkey)",
                "create index li_pk on lineitem(l_partkey, l_suppkey)",
                "create index li_sk on lineitem(l_suppkey)",
                "create index o_ok on orders(o_orderkey)",
                "create index o_ck on orders(o_custkey)",
                "create index c_ck on customer(c_custkey)",
                "create index s_sk on supplier(s_suppkey)",
                "create index p_pk on part(p_partkey)",
                "create index ps_pk on partsupp(ps_partkey, ps_suppkey)",
                "create index ps_sk on partsupp(ps_suppkey)"):
        conn.execute(ddl)
    conn.execute("analyze")
    conn.commit()
    return conn


def _normal(v):
    """A result value for comparison: numeric strings (decimals) -> float."""
    if isinstance(v, str) and v:
        body = v[1:] if v[0] in "+-" else v
        if body.replace(".", "", 1).isdigit():
            return float(v)
    return v


def rows_equal(got, want, rel_tol: float = 1e-6):
    """(ok, message): the rows in order, numbers within rel_tol (sqlite keeps
    decimals as REAL), everything else equal (testutil.rows_equal's rule)."""
    if len(got) != len(want):
        return False, f"row count {len(got)} != {len(want)}: {got[:3]} vs {want[:3]}"
    for i, (rg, rw) in enumerate(zip(got, want)):
        if len(rg) != len(rw):
            return False, f"row {i}: width {len(rg)} != {len(rw)}"
        for j, (a, b) in enumerate(zip(map(_normal, rg), map(_normal, rw))):
            if a is None or b is None:
                ok = a is b
            elif isinstance(a, (int, float)) and isinstance(b, (int, float)):
                ok = abs(a - b) <= rel_tol * max(1.0, abs(a), abs(b))
            else:
                ok = a == b
            if not ok:
                return False, f"row {i} col {j}: {rg[j]!r} != {rw[j]!r}"
    return True, "ok"


def phase_grid(torch, np, Session, mods) -> tuple:
    """All 22 TPC-H queries at SF0.1 (the port's generator, seed 7, chunk
    capacity 8,192) on the card against the sqlite oracle, ordered, with
    the oracle's SQL variants, twice: as loaded (no statistics), then
    after ANALYZE TABLE of the eight tables (the plans an analyzed catalog
    gives, as after any committed DML). Each run: the probe kernel's
    launch contract, the fused fragments its plan (taken just before)
    calls for, and the device generic aggregation on exactly the queries
    whose plans group generically (GENERIC_QUERIES: ANALYZE changes the
    estimates and join orders, not which queries group generically), fused
    at least for Q15, Q17, Q18 and Q20. Plan-time subqueries may add fragments beyond the final
    plan's (Q11's HAVING subquery groups partsupp fused at this scale).
    Returns (report, the SF0.1 catalog, the oracle): the mesh phase reruns
    the grid on four shards."""
    s = Session(chunk_capacity=8192)
    t0 = time.perf_counter()
    counts = s.load_tpch(0.1)
    t_load = time.perf_counter() - t0
    oracle = sqlite_oracle(np, s.catalog)
    log(f"grid: SF0.1 loaded in {t_load:.1f} s ({counts}); sqlite oracle built in "
        f"{time.perf_counter() - t0 - t_load:.1f} s")
    out = {"unanalyzed": grid_pass(s, mods, oracle, GENERIC_QUERIES, "grid")}
    t0 = time.perf_counter()
    s.execute("analyze table " + ", ".join(TPCH_TABLES))
    log(f"grid: ANALYZE TABLE of the eight tables in {time.perf_counter() - t0:.1f} s")
    out["analyzed"] = grid_pass(s, mods, oracle, GENERIC_QUERIES, "grid analyzed")
    out["plans_changed"] = [q for q in out["analyzed"]
                            if plan_shape(out["analyzed"][q]["plan"])
                            != plan_shape(out["unanalyzed"][q]["plan"])]
    log(f"grid: plans whose operators ANALYZE changed: {out['plans_changed']}")
    return out, s.catalog.base, oracle


def grid_pass(s, mods, oracle, generic, label) -> dict:
    """One pass of the 22 queries; see phase_grid."""
    from tidb_tpu_torch.planner.physical import explain_text
    from tidb_tpu_torch.storage.tpch_queries import Q

    out = {}
    for name, (sql, osql) in Q.items():
        plan = planned(s, sql)
        want = plan_fragments(plan, s._plan_capacity(plan))
        rows, cnt, dt = run_query(s, mods, sql)
        expect = oracle.execute(osql or sql).fetchall()
        ok, msg = rows_equal(rows, expect)
        if not ok:
            raise AssertionError(f"{label} {name}: {msg}")
        if not rows and name != "q9":
            raise AssertionError(f"{label} {name} returned no rows")
        lc, gen = cnt["launches"], cnt["generic_runs"]
        if lc["segsum_count"] or lc["segsum_i64"] or lc["hash_probe"]:
            raise AssertionError(f"{label} {name} launched an off-path kernel entry: {lc}")
        if lc["probe_count"] != sum(cnt["routes"].values()):
            raise AssertionError(f"{label} {name}: probe_count {lc['probe_count']} over "
                                 f"{cnt['routes']} probe chunks")
        if (gen["classic"] + gen["fused"] > 0) != (name in generic):
            raise AssertionError(f"{label} {name}: device generic runs {gen}")
        if name in FUSED_GENERIC_QUERIES and not gen["fused"]:
            raise AssertionError(f"{label} {name}: fused generic runs {gen}")
        ran = dict(cnt["fused"], generic_classic=gen["classic"])
        if any(ran[k] < want[k] for k in want):
            raise AssertionError(f"{label} {name}: ran {ran}, the plan calls for {want}")
        out[name] = {"rows": len(rows), "seconds": dt, "plan_fragments": want,
                     "fused": cnt["fused"], "generic_runs": gen, "routes": cnt["routes"],
                     "launches": lc, "checks_nothing": not rows,
                     "device_get": cnt["device_get"], "plan": explain_text(plan)}
        log(f"{label} {name}: {len(rows)} rows equal sqlite in {dt:.3f} s; "
            f"{cnt['device_get']} device_get; fused "
            f"{ {k: v for k, v in cnt['fused'].items() if v} }; device generic {gen}; "
            f"probe routes {cnt['routes']}" + ("; empty: checks nothing" if not rows else ""))
    return out


# ---------------------------------------------------------------------------
# the per-chunk loop of the device generic aggregation makes no host read
# ---------------------------------------------------------------------------


def sync_free_pass(torch, s, mods, sqls: dict) -> dict:
    """Run each statement (inline staging, so no other thread works in the
    window) with torch's sync debug mode set to "error" around every
    per-chunk step of the device generic aggregation: the fused batch
    function (decode, pipeline, partial table), the classic partial table
    and each push onto the GroupTableStack (its merges). A device->host
    copy, .item() or any other synchronising call in them raises. Returns
    the steps checked per statement."""
    from tidb_tpu_torch.executor import agg_device as ad
    from tidb_tpu_torch.executor import pipeline as pl
    from tidb_tpu_torch.utils import jitcache

    calls = {}

    def strict(fn, key):
        def run(*a):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*a)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            calls[key] = calls.get(key, 0) + 1
            return out
        return run

    def strict_builds(key):
        return lambda real: (lambda *a: strict(real(*a), key))

    real_push = ad.GroupTableStack.push
    ad.GroupTableStack.push = lambda self, t: strict(real_push, "push")(self, t)
    restores = [patch_builder(ad, "make_partial_kernel", strict_builds("partial")),
                patch_builder(pl, "_make_fused_generic_fn", strict_builds("fused_batch"))]
    s.execute("set tidb_tpu_pipeline_prefetch_depth = 0")
    out = {}
    try:
        for name, sql in sqls.items():
            calls.clear()
            # a graph captured by an earlier statement would replay this
            # one's batches past the wrappers: each statement warms up and
            # captures its own (both under the sync debug mode)
            jitcache.clear()
            rows, cnt, _dt = run_query(s, mods, sql)
            gen = cnt["generic_runs"]
            # every step the statement ran went through a wrapper: a fused
            # run built its batch function, a classic one its partial table
            if not calls.get("push"):
                raise AssertionError(f"{name}: no device generic aggregation step ran")
            if gen["fused"] and not calls.get("fused_batch"):
                raise AssertionError(f"{name}: {gen} ran, no fused batch was checked")
            if gen["classic"] and not calls.get("partial"):
                raise AssertionError(f"{name}: {gen} ran, no partial table was checked")
            out[name] = {"steps": dict(calls), "generic_runs": gen, "rows": len(rows)}
            log(f"sync-free per-chunk loop, {name}: {dict(calls)} steps under sync debug "
                f"mode 'error', none synchronised; device generic runs {gen}")
    finally:
        ad.GroupTableStack.push = real_push
        for restore in reversed(restores):
            restore()
        s.execute("set tidb_tpu_pipeline_prefetch_depth = 2")
    return out


# ---------------------------------------------------------------------------
# one device program per fused batch: CUDA-graph replay against eager
# ---------------------------------------------------------------------------

GRAPH_QUERIES = ("q1", "q6", "q3", "q5", "q18")
GRAPH_WARM = WARM_RUNS     # timed warm runs of each mode
GRAPH_MAX_RUNS = 6         # graph runs until one plan's second warm run
GRAPH_EAGER_PROFILED = ("q1",)  # eager profiles (the others: PERF.md)
# the replayed run profiled: Q18's eager outer aggregation (27,000 launches)
# made its profiled run 29 s at SF1, a cut for the script's time limit
GRAPH_PROFILED = ("q1",)  # (Q6, Q3 and Q5 too until the SF10 phase)


def _site_calls(programs: dict) -> dict:
    return {ns: sum(r.values()) for ns, r in programs.items()}


def phase_graphs(torch, np, s, mods, results) -> dict:
    """Q1, Q6, Q3, Q5 and Q18 at SF1, eagerly (utils/jitcache.py's
    explicit switch, jitcache.eager()) and by CUDA-graph replay, in turns
    on one session. Per query: the eager run and its per-site calls;
    graph runs from an empty cache (captures, then replays) until one
    plan runs a third time (plan feedback may move it), each with the
    rows equal to phase 2's (which equal numpy) and to the eager run's,
    the launch contract of its plan held (tidb_segagg once per
    aggregated chunk, tidb_probe_count once per probe chunk), and on that
    plan's second warm run no eager call and no capture, every fused
    batch a replay, the kernels' launches, the probe routes and the sanctioned
    device->host fetches equal to the eager run's (same plan); then the
    warm median of GRAPH_WARM runs of each mode, the bytes the graphs
    hold, and one profiled warm run by replay of GRAPH_PROFILED (and
    eagerly of GRAPH_EAGER_PROFILED): device busy and idle, host launches
    (kernels and graph launches apart)."""
    from tidb_tpu_torch.planner.physical import explain_text
    from tidb_tpu_torch.storage.tpch_queries import Q
    from tidb_tpu_torch.utils import jitcache

    agg_chunks = count_segment_chunks()
    rep = {"max_bytes": jitcache.max_bytes()}
    for q in GRAPH_QUERIES:
        sql = Q[q][0]
        r = rep[q] = {}
        with jitcache.eager():
            # a run first: the statements in between may have evicted this
            # query's builds from the device buffer cache (a rebuild reads
            # the host), and the counted run must find them as the replays do
            s.query(sql)
            plan0 = explain_text(planned(s, sql))
            agg_chunks[0] = 0
            rows, eager, _dt = run_query(s, mods, sql)
            eager["aggregated_chunks"] = agg_chunks[0]
            if rows != results[q]:
                raise AssertionError(f"graphs {q}: the eager run's rows differ from phase 2's")
            warm = []
            for _ in range(GRAPH_WARM):
                t0 = time.perf_counter()
                again = s.query(sql)
                warm.append(time.perf_counter() - t0)
                if again != rows:
                    raise AssertionError(f"graphs {q}: an eager warm run's rows differ")
        if any(set(v) != {"eager"} for v in eager["programs"].values()):
            raise AssertionError(f"graphs {q}: the eager switch ran a graph: "
                                 f"{eager['programs']}")
        r["eager"] = {"programs": eager["programs"], "launches": eager["launches"],
                      "routes": eager["routes"], "device_get": eager["device_get"],
                      "warm_s": warm, "median_s": statistics.median(warm)}
        jitcache.clear()
        runs, seen, last = [], {}, None
        for i in range(GRAPH_MAX_RUNS):
            # plan feedback may move the plan between runs (Q18's
            # push-down exploration): the checked run is the first whose
            # plan ran twice before it, cold and warm
            plan = planned(s, sql)
            text = explain_text(plan)
            want = plan_fragments(plan, s._plan_capacity(plan))
            agg_chunks[0] = 0
            got, cnt, dt = run_query(s, mods, sql)
            cnt["aggregated_chunks"] = agg_chunks[0]
            if got != rows:
                raise AssertionError(f"graphs {q} run {i + 1}: rows differ from the eager run's")
            check_path(f"graphs {q} run {i + 1}", cnt, agg_chunks[0], want)
            cnt["same_plan"] = text == plan0
            cnt["plan_runs_before"] = seen.get(text, 0)
            seen[text] = cnt["plan_runs_before"] + 1
            runs.append(cnt)
            log(f"graphs {q} run {i + 1}: {dt * 1e3:.3f} ms; cached programs "
                f"{cnt['programs']}; launches {cnt['launches']}; routes {cnt['routes']}; "
                f"device_get {cnt['device_get']}; aggregated chunks {agg_chunks[0]}; "
                f"this plan's runs before {cnt['plan_runs_before']}")
            if cnt["plan_runs_before"] >= 2:
                last = cnt
                break
        if last is None:
            raise AssertionError(f"graphs {q}: no plan ran a third time in {GRAPH_MAX_RUNS} runs")
        if not last["programs"]:
            raise AssertionError(f"graphs {q}: no fused batch went through the cache")
        for ns, by in last["programs"].items():
            if by.get("eager") or by.get("capture") or not by.get("replay"):
                raise AssertionError(f"graphs {q}: the second warm run's {ns} batches ran "
                                     f"{by}, not all by replay")
        if last["same_plan"]:
            if _site_calls(last["programs"]) != _site_calls(eager["programs"]):
                raise AssertionError(f"graphs {q}: replays {last['programs']} against the "
                                     f"eager run's batches {eager['programs']}")
            for k in ("launches", "routes", "device_get"):
                if last[k] != eager[k]:
                    raise AssertionError(f"graphs {q}: {k} {last[k]} by replay, {eager[k]} "
                                         f"eagerly")
        else:
            log(f"note: graphs {q}: plan feedback moved the plan between the eager run "
                f"and the replays; counts compared with the plan's own contract only")
        warm = []
        for _ in range(GRAPH_WARM):
            t0 = time.perf_counter()
            again = s.query(sql)
            warm.append(time.perf_counter() - t0)
            if again != rows:
                raise AssertionError(f"graphs {q}: a replayed warm run's rows differ")
        r["graphs"] = {"runs": [{k: c[k] for k in ("programs", "launches", "routes",
                                                   "device_get", "aggregated_chunks",
                                                   "same_plan", "plan_runs_before")}
                                for c in runs],
                       "warm_s": warm, "median_s": statistics.median(warm),
                       "graph_bytes": jitcache.graph_bytes(),
                       "resident_bytes": jitcache.resident_bytes()}
        line = (f"graphs {q}: warm median eager {r['eager']['median_s'] * 1e3:.3f} ms, "
                f"replay {r['graphs']['median_s'] * 1e3:.3f} ms (runs eager "
                f"{[round(x * 1e3, 3) for x in r['eager']['warm_s']]}, replay "
                f"{[round(x * 1e3, 3) for x in warm]}); graph bytes "
                f"{r['graphs']['graph_bytes']} ({r['graphs']['resident_bytes']} resident, "
                f"bound {jitcache.max_bytes()})")
        if q in GRAPH_PROFILED:
            r["graphs"]["profile"] = prof = profile_query(torch, s, sql)
            line += (f"; replay profile: device busy {prof['device_busy_us'] / 1e3:.3f} ms, "
                     f"idle {prof['idle_share']:.3f}, host launches {prof['host_launches']}")
        if q in GRAPH_EAGER_PROFILED:
            with jitcache.eager():
                r["eager"]["profile"] = ep = profile_query(torch, s, sql)
            line += (f"; eager profile: device busy {ep['device_busy_us'] / 1e3:.3f} ms, "
                     f"idle {ep['idle_share']:.3f}, host launches {ep['host_launches']}")
        log(line)
    return rep


# ---------------------------------------------------------------------------
# the fused scan -> top-k root at SF1
# ---------------------------------------------------------------------------

TOPN_SQL = ("select l_orderkey, l_linenumber, l_extendedprice from lineitem "
            "where l_shipdate >= date '1995-01-01' order by l_extendedprice desc")


def numpy_topn(np, li, limit: int, multi: bool):
    """The top `limit` lineitems shipped since 1995 by extendedprice desc: with
    `multi`, then by orderkey and linenumber; else ties in drain (row) order."""
    ship, ext, okey, lnum = _cols(li, "l_shipdate", "l_extendedprice", "l_orderkey",
                                  "l_linenumber")
    rows = np.nonzero(ship >= _days(np, "1995-01-01"))[0]
    if multi:
        order = np.lexsort((lnum[rows], okey[rows], -ext[rows]))
    else:
        order = np.argsort(-ext[rows], kind="stable")
    top = rows[order[:limit]]
    return [(int(okey[i]), int(lnum[i]), int(ext[i])) for i in top]


def phase_topn(np, s, mods) -> dict:
    """A top-N report over lineitem at SF1 with one sort key (the threshold
    cut), with three (the full merge) and with a LIMIT above the chunk
    capacity (the classic delegate), each against numpy; the first two must
    run fused."""
    li = s.catalog.table("test", "lineitem")
    cases = {"single_key": (TOPN_SQL + " limit 10", 10, False, "topn"),
             "multi_key": (TOPN_SQL + ", l_orderkey, l_linenumber limit 100", 100, True,
                           "topn"),
             "over_capacity": (TOPN_SQL + " limit 70000", 70000, False, "delegate")}
    out = {}
    for name, (sql, limit, multi, route) in cases.items():
        runs = []
        for _ in range(2):
            rows, cnt, dt = run_query(s, mods, sql)
            runs.append(dt)
        got = [(r[0], r[1], _scaled(r[2])) for r in rows]
        want = numpy_topn(np, li, limit, multi)
        if got != want:
            raise AssertionError(f"top-k {name}: {got[:3]} vs numpy {want[:3]}")
        if cnt["fused"][route] != 1 or cnt["fused"]["topn"] != (route == "topn"):
            raise AssertionError(f"top-k {name} took {cnt['fused']}, not {route}")
        out[name] = {"rows": len(rows), "seconds": runs, "fused": cnt["fused"],
                     "h2d": cnt["h2d"], "staged_batches": cnt["staged_batches"]}
        log(f"top-k {name}: {len(rows)} rows equal numpy; route {route}; cold/warm s {runs}; "
            f"staged batches {cnt['staged_batches']}")
    return out


def peak_memory(torch, s, sql: str) -> dict:
    """The card's allocated bytes before one warm run of `sql` and the
    allocator's peak during it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s.query(sql)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"before_bytes": base, "peak_bytes": peak, "statement_peak_bytes": peak - base}



# -- the refresh phase: keys, index access and the write path at SF1 ----------

REFRESH_QUERIES = ("q1", "q6", "q3", "q5", "q18")
# the route and mode ("route/mode", as with_probe_modes records them) of
# each kernels-line row of tidb_probe_count at the main path's shapes
PROBE_ROW_MODES = {"probe_count.table_flags": "table/flags",
                   "probe_count.table_full": "table/full",
                   "probe_count.direct": "direct/full", "probe_count.sorted": "sorted/full",
                   "probe_count.direct_flags": "direct/flags"}


class ModelTable:
    """A table of the numpy model: live rows' columns in the engine's
    device representation, with the engine table's dictionaries."""

    def __init__(self, data, dicts):
        self.data, self.dicts = data, dicts

    @property
    def n(self) -> int:
        return len(next(iter(self.data.values())))


class ArrayModel:
    """An independent numpy model of orders and lineitem for the refresh
    phase: their live rows copied once after the load, then RF1's rows
    appended, RF2's orders and lineitems dropped and the UPDATE applied,
    by numpy alone. Its `table()` serves the numpy queries (numpy_q1 ...
    numpy_q18) in place of the catalog; the other tables, which no
    refresh statement touches, are the catalog's own."""

    COLS = {"lineitem": ("l_orderkey", "l_suppkey", "l_linenumber", "l_quantity",
                         "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
                         "l_linestatus", "l_shipdate"),
            "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority",
                       "o_totalprice")}

    def __init__(self, np, cat):
        self.np, self.cat = np, cat
        self.tables = {}
        for name, cols in self.COLS.items():
            t = cat.table("test", name)
            live = np.nonzero(t.live_mask(0, t.n))[0]
            self.tables[name] = ModelTable({c: t.data[c][live].copy() for c in cols},
                                           t.dicts)

    def table(self, db, name):
        return self.tables[name] if name in self.tables else self.cat.table(db, name)

    def append(self, new):
        for name, m in self.tables.items():
            m.data = {c: self.np.concatenate([a, new[name][c]]) for c, a in m.data.items()}

    def drop_orders(self, keys):
        np = self.np
        for name, col in (("lineitem", "l_orderkey"), ("orders", "o_orderkey")):
            m = self.tables[name]
            keep = ~np.isin(m.data[col], keys)
            m.data = {c: a[keep] for c, a in m.data.items()}

    def copy(self) -> "ArrayModel":
        out = ArrayModel.__new__(ArrayModel)
        out.np, out.cat = self.np, self.cat
        out.tables = {k: ModelTable(dict(v.data), v.dicts) for k, v in self.tables.items()}
        return out

    def set_discount(self, lo_day: int, hi_day: int, scaled: int):
        li = self.tables["lineitem"]
        d = li.data["l_shipdate"]
        li.data["l_discount"] = li.data["l_discount"].copy()
        li.data["l_discount"][(d >= lo_day) & (d < hi_day)] = scaled


def check_five(np, res, model, label):
    """Q1, Q6, Q3, Q5 and Q18 rows against numpy over the model."""
    li = model.table("test", "lineitem")
    check_q1(np, res["q1"], numpy_q1(np, li))
    if len(res["q6"]) != 1 or _scaled(res["q6"][0][0]) != numpy_q6(np, li):
        raise AssertionError(f"{label}: Q6 {res['q6']} vs numpy {numpy_q6(np, li)}")
    check_join_rows("q3", res["q3"], numpy_q3(np, model), {1})
    check_join_rows("q5", res["q5"], numpy_q5(np, model), {1})
    check_join_rows("q18", res["q18"], numpy_q18(np, model)[0], {4, 5})
    if not all(res[q] for q in REFRESH_QUERIES):
        raise AssertionError(f"{label}: a query returned no rows")


def refresh_queries(np, s, mods, model, label, step) -> dict:
    """The five queries after a DML, Q1 and Q6 twice: the first run of each
    restages its table (no cache hit), the second stages 0 B; every row
    against numpy over the model. Launches and staging into `step`."""
    from tidb_tpu_torch.storage.tpch_queries import Q

    res = {}
    li = s.catalog.table("test", "lineitem")
    runs = ["q1", "q1_again", "q6", "q6_again", "q3", "q5", "q18"]
    while runs:
        run = runs.pop(0)
        q = run.split("_")[0]
        epoch = li.data_epoch
        rows, c, dt = run_query(s, mods, Q[q][0])
        step["queries"][run] = {"s": dt, "launches": c["launches"], "routes": c["routes"],
                                "h2d": c["h2d"], "staged_batches": c["staged_batches"],
                                "cache": c["cache"], "fused": c["fused"],
                                "segments": c["segments"]}
        step_add(step, c)
        if li.data_epoch != epoch:
            # CLUSTER BY: the DML's delta made a fold due, and the re-sort
            # ran at the end of this statement (a quiescent boundary). Its
            # rows moved, so the next run restages them once; one more run
            # then must stage nothing
            step.setdefault("resorted_after", []).append(run)
            if run.endswith("_again") or run.endswith("_resorted"):
                raise AssertionError(f"{label}: {run} re-sorted lineitem again")
            if q in ("q1", "q6"):
                runs.insert(runs.index(q + "_again"), q + "_resorted")
        if run.endswith("_resorted"):
            if rows != res[q]:
                raise AssertionError(f"{label}: {run} differs from the first run")
            if c["cache"]["hit"] or not c["staged_batches"]:
                raise AssertionError(f"{label}: {run} did not restage the re-sorted "
                                     f"rows: {c}")
        elif run == q:
            res[q] = rows
            if q in ("q1", "q6") and (c["cache"]["hit"] or not c["staged_batches"]
                                      or not c["h2d"]["h2d"]):
                raise AssertionError(f"{label}: the first {q} after the DML did not "
                                     f"restage: {c}")
        else:
            if rows != res[q]:
                raise AssertionError(f"{label}: {run} differs from the first run")
            if c["h2d"]["h2d"] or c["staged_batches"] or not c["cache"]["hit"]:
                raise AssertionError(f"{label}: {run} staged again: {c}")
        log(f"refresh {label} {run}: {dt:.3f} s; launches {c['launches']}; host->device "
            f"{c['h2d']}; staged batches {c['staged_batches']}; cache {c['cache']}")
    check_five(np, res, model, label)
    log(f"refresh {label}: Q1, Q6, Q3, Q5 and Q18 equal numpy over the model")
    return res


def step_add(step, c):
    for k in ("segagg", "probe_count", "hash_probe", "segsum_count", "segsum_i64"):
        step["launches"][k] = step["launches"].get(k, 0) + c["launches"][k]


def new_step():
    return {"launches": {}, "queries": {}, "statements": []}


def timed(step, s, mods, sql, label=None) -> dict:
    """Run one refresh statement with the kernels' launch counters and
    the join's probe-route counter set to 0 just before it and read just
    after, as run_query does; its time, launches and probe chunks by
    route into `step`."""
    seg_mod, hp, jk = mods[0], mods[1], mods[2]
    seg_mod.reset_launches()
    hp.reset_launches()
    jk.reset_routes()
    t0 = time.perf_counter()
    s.execute(sql)
    dt = time.perf_counter() - t0
    got = launches_of(mods)
    rec = {"sql": label or sql[:80], "s": dt, "launches": got,
           "routes": dict(jk.PROBE_ROUTES)}
    step["statements"].append(rec)
    step_add(step, {"launches": got})
    return rec


def launches_of(mods) -> dict:
    seg_mod, hp = mods[0], mods[1]
    return {**seg_mod.LAUNCHES, **hp.LAUNCHES}


def access_leaf(s, sql):
    from tidb_tpu_torch.planner.physical import PScan

    node = planned(s, sql)
    while node.children and not isinstance(node, PScan):
        node = node.children[0]
    return node


def point_get(np, s, model, key, step, label):
    """`select * from orders where o_orderkey = key` through PPointGet,
    against the model's row; its time into `step`."""
    from tidb_tpu_torch.planner.physical import PPointGet

    sql = f"select * from orders where o_orderkey = {key}"
    if type(access_leaf(s, sql)) is not PPointGet:
        raise AssertionError(f"{sql} does not plan PPointGet")
    t0 = time.perf_counter()
    rows = s.query(sql)
    dt = time.perf_counter() - t0
    o = model.table("test", "orders")
    hit = np.nonzero(o.data["o_orderkey"] == key)[0]
    want = [(int(key), int(o.data["o_custkey"][i]), int(o.data["o_totalprice"][i]),
             _iso(np, o.data["o_orderdate"][i])) for i in hit]
    got = [(r[0], r[1], _scaled(r[3]), r[4]) for r in rows]
    if got != want:
        raise AssertionError(f"{label}: point get {got} vs numpy {want}")
    step["lookups"].append({"what": label, "s": dt, "rows": len(rows)})
    log(f"refresh lookup {label}: {dt * 1e3:.3f} ms, {len(rows)} row(s)")
    return dt


def lineitem_range(np, s, model, lo, hi, step, label, eq=False):
    """Lineitems of orders lo..hi (BETWEEN), or of order lo alone (the
    composite key's equality prefix), against the model."""
    from tidb_tpu_torch.planner.physical import explain_text

    where = f"l_orderkey = {lo}" if eq else f"l_orderkey between {lo} and {hi}"
    sql = f"select l_orderkey, l_linenumber, l_quantity from lineitem where {where}"
    leaf = access_leaf(s, sql)
    t0 = time.perf_counter()
    rows = sorted(s.query(sql))
    dt = time.perf_counter() - t0
    li = model.table("test", "lineitem")
    k = li.data["l_orderkey"]
    m = (k == lo) if eq else (k >= lo) & (k <= hi)
    want = sorted(zip(k[m].tolist(), li.data["l_linenumber"][m].tolist(),
                      li.data["l_quantity"][m].tolist()))
    if [(a, b, _scaled(c)) for a, b, c in rows] != want:
        raise AssertionError(f"{label}: {len(rows)} lineitems vs numpy {len(want)}")
    plan = explain_text(planned(s, sql))
    step["lookups"].append({"what": label, "s": dt, "rows": len(rows),
                            "access": type(leaf).__name__, "plan": plan})
    log(f"refresh lookup {label}: {type(leaf).__name__}, {dt * 1e3:.3f} ms, "
        f"{len(rows)} rows; plan:\n{plan}")
    return type(leaf).__name__


def refused(s, sql):
    """The statement must fail with the reference's duplicate-key error."""
    from tidb_tpu_torch.errors import ExecutionError

    try:
        s.execute(sql)
    except ExecutionError as e:
        if "duplicate entry for unique index" not in str(e):
            raise
        return str(e)
    raise AssertionError(f"accepted a duplicate key: {sql[:120]}")


def phase_refresh(torch, np, s, mods, load, sf: float = 1.0) -> dict:
    """Keys, index access and the write path at SF1 on the phase-2 session:
    duplicate keys refused, point and range access, TPC-H RF1 in one
    explicit transaction (a second session reads the pre-RF1 rows, the
    writer its own), RF2 as multi-table DELETEs through a key table, an
    UPDATE rolled back and one committed, TRUNCATE of a scratch table; the
    five queries against an independent numpy model after each DML.
    Each statement (timed) and each query (run_query) runs with the launch
    counters set to 0 just before it and read just after; the phase's
    launches are the sum of those readings, and its probe_count launches
    by route and mode are counted by a wrapper over the whole phase."""
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import tpch_refresh as rf
    from tidb_tpu_torch.storage.tpch_queries import Q

    seg_mod, hp, jk, pl, st, agg_mod = mods
    cat = s.catalog
    o, li = cat.table("test", "orders"), cat.table("test", "lineitem")
    model = ArrayModel(np, cat)
    report = {"load": load, "steps": {}}
    log(f"refresh: the SF{sf:g} load took {load['load_s']:.3f} s, of which the primary-key "
        f"checks {load['pk_check_s']:.3f} s ({load['pk_check_s'] / load['load_s']:.1%}); "
        f"per table {load['pk_check_by_table']}")
    probes = record_probe_chunks(hp)
    probes["query"] = "refresh"
    try:
        # 1. keys: a duplicate o_orderkey and a duplicate (l_orderkey,
        # l_linenumber) are refused, the row counts unchanged
        step = report["steps"]["keys"] = new_step()
        n0 = (o.live_rows, li.live_rows)
        live_o = np.nonzero(o.live_mask(0, o.n))[0][:1]
        live_l = np.nonzero(li.live_mask(0, li.n))[0][:1]
        dup_o = rf.insert_statements(o, {c: o.data[c][live_o] for c in o.schema.names()})[0]
        dup_l = rf.insert_statements(li, {c: li.data[c][live_l] for c in li.schema.names()})[0]
        step["refused"] = [refused(s, dup_o), refused(s, dup_l)]
        if (o.live_rows, li.live_rows) != n0:
            raise AssertionError("a refused duplicate changed a row count")
        log(f"refresh keys: both duplicates refused ({step['refused']}); rows {n0}")

        # 2. access paths: a point get on orders, a range and an
        # equality-prefix scan of lineitem; the first lookup of each index
        # builds its sorted (key, row) cache
        step = report["steps"]["access"] = new_step()
        step["lookups"] = []
        keys = np.sort(model.table("test", "orders").data["o_orderkey"])
        k_mid = int(keys[len(keys) // 2])
        point_get(np, s, model, k_mid, step, "orders point get, first (builds the index)")
        point_get(np, s, model, k_mid, step, "orders point get, warm")
        step["range_access"] = lineitem_range(np, s, model, k_mid, k_mid + 200, step,
                                              "lineitem l_orderkey between k and k + 200")
        if lineitem_range(np, s, model, k_mid, None, step,
                          "lineitem l_orderkey = k, first (builds the index)",
                          eq=True) != "PIndexRangeScan":
            raise AssertionError("the composite key's equality prefix did not plan "
                                 "PIndexRangeScan")
        lineitem_range(np, s, model, k_mid, None, step, "lineitem l_orderkey = k, warm",
                       eq=True)

        # 3. RF1 (clause 2.5.2) in one explicit transaction
        step = report["steps"]["rf1"] = new_step()
        epochs = (o.data_epoch, li.data_epoch)
        new = rf.rf1(cat, sf, seed=7)
        stmts = [("orders", q) for q in rf.insert_statements(o, new["orders"])] + [
            ("lineitem", q) for q in rf.insert_statements(li, new["lineitem"])]
        other = Session(catalog=cat, device=s.device)
        before_q1, before_q6 = numpy_q1(np, model.table("test", "lineitem")), \
            numpy_q6(np, model.table("test", "lineitem"))
        if stats_fresh(o) or stats_fresh(li):
            raise AssertionError("orders or lineitem carry statistics before RF1: the "
                                 "bulk load does not analyze")
        step["plans_before"] = five_plans(s)
        timed(step, s, mods, "begin")
        for name, q in stmts:
            timed(step, s, mods, q, f"insert into {name} ({q.count('), (') + 1} rows)")
        # before COMMIT: another session reads the pre-RF1 rows ...
        rows, c, dt = run_query(other, mods, Q["q1"][0])
        check_q1(np, rows, before_q1)
        step["queries"]["q1_other_session"] = {"s": dt, "h2d": c["h2d"], "cache": c["cache"]}
        step_add(step, c)
        rows, c, dt = run_query(other, mods, Q["q6"][0])
        if _scaled(rows[0][0]) != before_q6:
            raise AssertionError(f"another session's Q6 saw provisional rows: {rows}")
        step_add(step, c)
        # ... and the writer its own provisional rows, through the fused
        # pipeline's marker path (no device buffer cache in a transaction)
        model.append(new)
        rows, c, dt = run_query(s, mods, Q["q1"][0])
        check_q1(np, rows, numpy_q1(np, model.table("test", "lineitem")))
        if c["fused"]["agg"] != 1 or c["cache"]["hit"] or not c["staged_batches"]:
            raise AssertionError(f"the writer's Q1 did not run fused and uncached: {c}")
        step["queries"]["q1_writer_in_txn"] = {"s": dt, "h2d": c["h2d"], "cache": c["cache"],
                                              "fused": c["fused"]}
        step_add(step, c)
        # the COMMIT auto-analyzes both tables (the reference's rule: no
        # statistics, at least 1,024 rows, modify_count > 0)
        with timed_analyze({}) as analyzed:
            rec = timed(step, s, mods, "commit")
        rec["analyze_s"] = analyzed
        step["commit"] = {"s": rec["s"], "analyze_s": analyzed,
                          "without_analyze_s": rec["s"] - sum(analyzed.values())}
        if set(analyzed) != {"orders", "lineitem"} or not (
                stats_fresh(o) and stats_fresh(li)) or o.modify_count or li.modify_count:
            raise AssertionError(f"RF1's COMMIT analyzed {analyzed}, not orders and "
                                 "lineitem")
        log(f"refresh rf1: COMMIT {rec['s']:.3f} s, of which auto-analyze "
            f"{ {k: round(v, 3) for k, v in analyzed.items()} } s "
            f"({step['commit']['without_analyze_s']:.3f} s without it)")
        step["plans_after"] = five_plans(s)
        log_plans("refresh: before RF1", step["plans_before"])
        log_plans("refresh: after RF1's COMMIT", step["plans_after"], step["plans_before"])
        if (o.data_epoch, li.data_epoch) != epochs:
            raise AssertionError("RF1 rewrote dictionary codes")
        step["rows_inserted"] = {t: len(new[t][next(iter(new[t]))]) for t in new}
        log(f"refresh rf1: inserted {step['rows_inserted']}; statements "
            f"{[round(x['s'], 3) for x in step['statements']]} s")
        refresh_queries(np, s, mods, model, "after rf1", step)

        # 4. RF2 (clause 2.5.3): the oldest orders, through a key table
        step = report["steps"]["rf2"] = new_step()
        keys = rf.rf2_keys(cat, sf)
        n_before = (o.live_rows, li.live_rows)
        timed(step, s, mods, "create table rf2_keys (k bigint primary key)")
        timed(step, s, mods, "insert into rf2_keys values " + ", ".join(f"({k})" for k in keys),
              f"insert into rf2_keys ({len(keys)} rows)")
        for sql in ("delete lineitem from lineitem join rf2_keys on l_orderkey = k",
                    "delete orders from orders join rf2_keys on o_orderkey = k"):
            rec = timed(step, s, mods, sql)
            n = rec["launches"]["probe_count"]
            if not n or n != sum(rec["routes"].values()):
                raise AssertionError(f"{sql}: probe_count {n}, routes {rec['routes']}")
        model.drop_orders(keys)
        step["rows_deleted"] = {"orders": n_before[0] - o.live_rows,
                                "lineitem": n_before[1] - li.live_rows}
        if step["rows_deleted"]["orders"] != len(keys) or (
                li.live_rows != model.table("test", "lineitem").n):
            raise AssertionError(f"rf2 deleted {step['rows_deleted']} of {len(keys)} orders")
        log(f"refresh rf2: deleted {step['rows_deleted']}; statements "
            f"{[(x['sql'][:40], round(x['s'], 3)) for x in step['statements']]}")
        refresh_queries(np, s, mods, model, "after rf2", step)
        step["lookups"] = []
        point_get(np, s, model, int(keys[0]), step, "orders point get of a deleted key, "
                  "first after the DML (re-sorts the index)")
        point_get(np, s, model, k_mid, step, "orders point get, warm")

        # 5. an UPDATE rolled back, then committed; TRUNCATE of a scratch copy
        step = report["steps"]["update"] = new_step()
        lo, hi = _days(np, "1994-01-01"), _days(np, "1995-01-01")
        upd = ("update lineitem set l_discount = 0.06 where l_shipdate >= '1994-01-01' "
               "and l_shipdate < '1995-01-01'")
        q6_before = numpy_q6(np, model.table("test", "lineitem"))
        n_phys = li.n
        timed(step, s, mods, "begin")
        timed(step, s, mods, upd)
        step["rows_updated"] = li.n - n_phys
        rows, c, dt = run_query(s, mods, Q["q6"][0])
        step_add(step, c)
        check = model.copy()
        check.set_discount(lo, hi, 6)
        if _scaled(rows[0][0]) != numpy_q6(np, check.table("test", "lineitem")):
            raise AssertionError(f"the writer's Q6 missed its own UPDATE: {rows}")
        timed(step, s, mods, "rollback")
        rows, c, dt = run_query(s, mods, Q["q6"][0])
        step_add(step, c)
        step["queries"]["q6_after_rollback"] = {"s": dt, "h2d": c["h2d"], "cache": c["cache"]}
        if _scaled(rows[0][0]) != q6_before or c["cache"]["hit"]:
            raise AssertionError(f"Q6 after ROLLBACK: {rows} (numpy {q6_before}), cache "
                                 f"{c['cache']}")
        timed(step, s, mods, upd, "update (autocommit)")
        model.set_discount(lo, hi, 6)
        log(f"refresh update: {step['rows_updated']} rows; statements "
            f"{[(x['sql'][:40], round(x['s'], 3)) for x in step['statements']]}")
        res = refresh_queries(np, s, mods, model, "after the update", step)
        if _scaled(res["q6"][0][0]) == q6_before:
            raise AssertionError("the committed UPDATE did not move Q6")

        # the scratch copy: the lineitems of 25,000 orders (about 100,000
        # rows, enough for a segment store), by INSERT ... SELECT
        step = report["steps"]["truncate"] = new_step()
        okeys = np.sort(model.table("test", "orders").data["o_orderkey"])
        cut = int(okeys[min(25000, len(okeys) - 1)])
        timed(step, s, mods, "create table li_scratch (l_orderkey bigint, "
              "l_quantity decimal(15,2), l_extendedprice decimal(15,2), "
              "l_discount decimal(15,2), l_shipdate date)")
        timed(step, s, mods, "insert into li_scratch select l_orderkey, l_quantity, "
              "l_extendedprice, l_discount, l_shipdate from lineitem "
              f"where l_orderkey <= {cut}", "insert into li_scratch select ... from lineitem")
        scratch = cat.table("test", "li_scratch")
        q6s = Q["q6"][0].replace("lineitem", "li_scratch")
        m = model.table("test", "lineitem")
        part = ModelTable({c: a[m.data["l_orderkey"] <= cut] for c, a in m.data.items()},
                          m.dicts)
        rows, c, dt = run_query(s, mods, q6s)
        step_add(step, c)
        if _scaled(rows[0][0]) != numpy_q6(np, part) or c["fused"]["agg"] != 1:
            raise AssertionError(f"scratch Q6 {rows} vs numpy {numpy_q6(np, part)}: {c}")
        step["scratch_rows"] = scratch.live_rows
        step["segment_store"] = scratch._segment_store is not None
        timed(step, s, mods, "truncate table li_scratch")
        rows, c, dt = run_query(s, mods, q6s)
        step_add(step, c)
        if rows != [(None,)] or c["fused"]["agg"] != 1:
            raise AssertionError(f"Q6 over the truncated table: {rows}, {c['fused']}")
        timed(step, s, mods, "insert into li_scratch values (1, 1.00, 100.00, 0.06, "
                       "'1994-06-01'), (2, 30.00, 100.00, 0.06, '1994-06-01')")
        rows, c, dt = run_query(s, mods, q6s)
        step_add(step, c)
        if rows != [("6.0000",)]:
            raise AssertionError(f"Q6 after the re-insert: {rows}")
        if not step["segment_store"]:
            raise AssertionError("the scratch table has no segment store to drop")
        log(f"refresh truncate: {step['scratch_rows']} scratch rows (segment store "
            f"{step['segment_store']}); Q6 zero rows after TRUNCATE, the re-insert seen; "
            f"statements {[(x['sql'][:40], round(x['s'], 3)) for x in step['statements']]}")
    finally:
        stop_recording(probes)
    total = {}
    for step in report["steps"].values():
        for k, v in step["launches"].items():
            total[k] = total.get(k, 0) + v
    modes = recorded_modes(probes)
    report["launches"], report["probe_modes"] = total, modes
    if not total.get("segagg") or not total.get("probe_count"):
        raise AssertionError(f"the refresh phase missed a kernel of its path: {total}")
    if total.get("hash_probe") or total.get("segsum_count") or total.get("segsum_i64"):
        raise AssertionError(f"the refresh phase launched an off-path entry: {total}")
    log(f"refresh: launches {total}; probe_count by route and mode {modes}")
    return report



# -- the schema phase: the reference's table layout and schema features ------

@contextlib.contextmanager
def timing(cls, attr, acc, key):
    """Add the host seconds of every `cls.attr` call inside the block to
    acc[key] (a method of storage.table.Table: the load's checks, the
    CLUSTER BY permute)."""
    real = getattr(cls, attr)

    def timed_call(self, *args, **kw):
        t1 = time.perf_counter()
        try:
            return real(self, *args, **kw)
        finally:
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t1

    setattr(cls, attr, timed_call)
    try:
        yield acc
    finally:
        setattr(cls, attr, real)


def phase_cluster(np, s, mods) -> dict:
    """The clustered store at SF1, before phase 2: the load declares
    CLUSTER BY (l_shipdate) on lineitem as the reference's does, and the
    first statement that folds lineitem into segments (a cold Q6 over the
    store in ingest order) queues the ordered compaction, which runs at
    that statement's end. Lineitem must then be sorted by l_shipdate with
    clustered_rows == n, and Q6 must equal numpy before and after. The
    permute's host time is reported; the device buffer cache is emptied
    so phase 2's first runs stay cold."""
    from tidb_tpu_torch.storage.table import Table
    from tidb_tpu_torch.storage.tpch_queries import Q

    seg_mod, hp, jk, pl, st, agg_mod = mods
    li = s.catalog.table("test", "lineitem")
    if li.schema.cluster_by != "l_shipdate":
        raise AssertionError(f"lineitem declares CLUSTER BY {li.schema.cluster_by!r}")
    if li.clustered_rows >= li.n:
        raise AssertionError("lineitem is in cluster order before its first fold")
    epoch, want = li.data_epoch, numpy_q6(np, li)
    acc = {}
    with timing(Table, "_recluster_locked", acc, "resort_s"):
        rows, c, dt = run_query(s, mods, Q["q6"][0])
    if len(rows) != 1 or _scaled(rows[0][0]) != want:
        raise AssertionError(f"Q6 over the unsorted store {rows} vs numpy {want}")
    ship = li.data["l_shipdate"][:li.n]
    if li.clustered_rows != li.n or li.data_epoch == epoch or (np.diff(ship) < 0).any():
        raise AssertionError(f"lineitem not re-sorted at the first fold: clustered_rows "
                             f"{li.clustered_rows} of {li.n}, epoch {epoch} -> "
                             f"{li.data_epoch}")
    if _scaled(s.query(Q["q6"][0])[0][0]) != numpy_q6(np, li):
        raise AssertionError("Q6 over the re-sorted store differs from numpy")
    pl.DEVICE_CACHE.clear()  # phase 2's first runs stage from the store
    out = {"resort_s": acc.get("resort_s", 0.0), "rows": li.n,
           "q6_before": {"s": dt, "segments": c["segments"],
                         "launches": c["launches"]["segagg"]},
           "compaction": dict(st.COMPACTION_TOTAL)}
    log(f"cluster: lineitem ({li.n} rows) sorted by l_shipdate at the first fold in "
        f"{out['resort_s']:.3f} s of host time (the cold Q6 that folded it: {dt:.3f} s, "
        f"segments scanned/pruned {c['segments']}, tidb_segagg {c['launches']['segagg']}); "
        f"clustered_rows == n; rebuilds {out['compaction']}")
    return out


def cluster_summary(per_query) -> dict:
    """Segments scanned and pruned and kernel launches of phase 2's fused
    runs over the clustered store, per query."""
    out = {}
    for run, c in per_query.items():
        out[run] = {"segments": c["segments"], "segagg": c["launches"]["segagg"],
                    "probe_count": c["launches"]["probe_count"]}
    log(f"cluster: phase 2 over the clustered store, per run: {out}")
    if out["q6"]["segments"]["pruned"] <= 0:
        raise AssertionError(f"Q6 pruned no segment of the clustered store: {out['q6']}")
    return out


def phase_compaction(np, s, mods) -> dict:
    """tidb_tpu_compaction on and off over the same ingest: a date-clustered
    copy of lineitem's Q6 columns (CLUSTER BY l_shipdate) gets two thirds
    of the rows in date order, then the rest in four appends of later
    dates, Q6 after each. With the worker on, each fold past
    tidb_tpu_segment_delta_rows is rebuilt by the background compaction
    worker (its queue drained after each query); off, inline on the
    statement path. Both must give the same rows (equal to numpy), the
    same physical order and clustered_rows, and the worker's rebuilds must
    have happened; each query's statement time is recorded per flag."""
    from tidb_tpu_torch.columnar import compaction
    from tidb_tpu_torch.storage.tpch_queries import Q

    seg_mod, hp, jk, pl, st, agg_mod = mods
    li = s.catalog.table("test", "lineitem")
    live = np.nonzero(li.live_mask(0, li.n))[0]
    live = live[np.argsort(li.data["l_shipdate"][live], kind="stable")]
    cols = ("l_orderkey", "l_quantity", "l_extendedprice", "l_discount", "l_shipdate")
    data = {c: li.data[c][live] for c in cols}
    n = len(live)
    cuts = [n * 2 // 3 + (n - n * 2 // 3) * k // 4 for k in range(5)]
    out = {}
    for flag in (1, 0):
        name = f"li_compact{flag}"
        s.execute(f"set tidb_tpu_compaction = {flag}")
        s.execute(f"create table {name} (l_orderkey bigint, l_quantity decimal(15,2), "
                  "l_extendedprice decimal(15,2), l_discount decimal(15,2), "
                  "l_shipdate date) cluster by (l_shipdate)")
        t = s.catalog.table("test", name)
        q6 = Q["q6"][0].replace("lineitem", name)
        c0 = dict(st.COMPACTION_TOTAL)
        runs, prev = [], 0
        for k, cut in enumerate(cuts):
            t.insert_columns({c: data[c][prev:cut] for c in cols})
            prev = cut
            rows, c, dt = run_query(s, mods, q6)
            want = numpy_q6(np, ModelTable({c_: data[c_][:cut] for c_ in cols}, {}))
            if len(rows) != 1 or _scaled(rows[0][0]) != want:
                raise AssertionError(f"{name} Q6 after append {k}: {rows} vs numpy {want}")
            drained = compaction.default_worker().drain(120) if flag else True
            if not drained:
                raise AssertionError("the compaction worker did not drain in 120 s")
            runs.append({"rows": cut, "s": dt, "segments": c["segments"],
                         "segagg": c["launches"]["segagg"], "covered":
                         t._segment_store.covered if t._segment_store else 0})
        got = {k: st.COMPACTION_TOTAL[k] - c0[k] for k in c0}
        out[flag] = {"runs": runs, "rebuilds": got, "clustered_rows": t.clustered_rows,
                     "n": t.n, "order": {c: t.data[c][:t.n].copy() for c in cols},
                     "q6": rows}
        log(f"compaction {flag}: rebuilds {got}; Q6 statement s per append "
            f"{[round(r['s'], 4) for r in runs]}; segments per run "
            f"{[r['segments'] for r in runs]}; covered {[r['covered'] for r in runs]}")
        s.execute(f"drop table {name}")
    s.execute("set tidb_tpu_compaction = 1")
    on, off = out[1], out[0]
    if on["q6"] != off["q6"] or (on["clustered_rows"], on["n"]) != (off["clustered_rows"],
                                                                    off["n"]):
        raise AssertionError("the compaction flag changed what a scan returns")
    for c in cols:
        if not np.array_equal(on["order"][c], off["order"][c]):
            raise AssertionError(f"the compaction flag changed the physical order of {c}")
    if on["rebuilds"]["background"] < 1 or off["rebuilds"]["background"]:
        raise AssertionError(f"background rebuilds: on {on['rebuilds']}, off "
                             f"{off['rebuilds']}")
    for v in out.values():
        del v["order"]
    return {"on": on, "off": off}


_COPY_COLS = ("l_orderkey", "l_linenumber", "l_quantity", "l_extendedprice", "l_discount",
              "l_tax", "l_returnflag", "l_linestatus", "l_shipdate")
_COPY_DDL = ("l_orderkey bigint, l_linenumber bigint, l_quantity decimal(15,2), "
             "l_extendedprice decimal(15,2), l_discount decimal(15,2), "
             "l_tax decimal(15,2), l_returnflag char(1), l_linestatus char(1), "
             "l_shipdate date")


def copy_columns(np, model):
    """(arrays, strings) of the model's live lineitems over _COPY_COLS, for
    Table.insert_columns: the string columns as Python strings."""
    m = model.table("test", "lineitem")
    arrays, strings = {}, {}
    for c in _COPY_COLS:
        if c in m.dicts:
            pool = np.array(m.dicts[c].values, dtype=object)
            strings[c] = pool[m.data[c]].tolist()
        else:
            arrays[c] = m.data[c]
    return arrays, strings


def model_where(model, mask) -> "ArrayModel":
    """A copy of `model` whose lineitem keeps the rows under `mask`."""
    out = model.copy()
    li = out.tables["lineitem"]
    li.data = {c: a[mask] for c, a in li.data.items()}
    return out


def expect_refusal(s, sql, words):
    """`sql` must fail with an error naming `words`."""
    try:
        s.execute(sql)
    except Exception as e:  # noqa: BLE001 — the refusal is the result
        if words not in str(e):
            raise
        return f"{type(e).__name__}: {e}"
    raise AssertionError(f"accepted: {sql[:160]}")


def phase_schema(torch, np, s, mods, sf: float = 1.0) -> dict:
    """The reference's schema features on the SF1 session after the
    refresh phase, each query against numpy over an array model of the
    tables' live rows (ArrayModel), each copy dropped once checked.

    Partitions: a copy of lineitem's query columns PARTITION BY RANGE
    (l_orderkey) in four partitions at the quartiles of the order keys,
    created by SQL and filled by the bulk path (insert_columns); Q1 and
    Q6 restricted to the first quartile plan a PartitionScanExec of p0
    feeding the segment aggregation (tidb_segagg), Q3 over the copy
    probes fused; a row past a bound-less RANGE is refused.
    Constraints: a copy with FOREIGN KEY (l_orderkey) REFERENCES orders,
    two CHECKs from TPC-H's domains and a stored DECIMAL(15,4) generated
    column l_extendedprice * (1 - l_discount): the load's FK, CHECK and
    generated-column times; Q1's sum_disc_price from the generated
    column; RF1 into the copy passes, a violating row and an orphan key
    are refused, deleting an order with live lineitems is refused, RF2 in
    TPC-H's order (lineitems, then orders) passes.
    DDL and transactions: ALTER TABLE ADD, MODIFY and DROP COLUMN on
    orders, Q3 after each; a SAVEPOINT inside RF1 rolled back to, Q1
    after; SELECT ... FOR UPDATE in one session refusing another
    session's UPDATE of the same order until COMMIT."""
    seg_mod, hp, jk, pl, st, agg_mod = mods
    probes = record_probe_chunks(hp)
    probes["query"] = "schema"
    try:
        report = schema_steps(np, s, mods, sf)
    finally:
        stop_recording(probes)
    modes = recorded_modes(probes)
    report["probe_modes"] = modes
    launches = {}
    for part in ("partitions", "constraints", "ddl"):
        for kname, v in report[part]["launches"].items():
            launches[kname] = launches.get(kname, 0) + v
    report["launches"] = launches
    if not launches.get("segagg") or not launches.get("probe_count"):
        raise AssertionError(f"the schema phase missed a kernel of its path: {launches}")
    if launches.get("hash_probe") or launches.get("segsum_count") \
            or launches.get("segsum_i64"):
        raise AssertionError(f"the schema phase launched an off-path entry: {launches}")
    log(f"schema: probe_count by route and mode {modes}")
    return report


def schema_steps(np, s, mods, sf: float) -> dict:
    """The three parts of phase_schema, in order; returns their reports."""
    from tidb_tpu_torch.planner.physical import PPartitionScan, explain_text
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import tpch_refresh as rf
    from tidb_tpu_torch.storage.table import Table
    from tidb_tpu_torch.storage.tpch_queries import Q

    cat = s.catalog
    o, li = cat.table("test", "orders"), cat.table("test", "lineitem")
    model = ArrayModel(np, cat)
    agg_chunks = count_segment_chunks()
    report = {}

    # -- partitions -----------------------------------------------------------
    okeys = np.sort(model.table("test", "orders").data["o_orderkey"])
    b = [int(okeys[len(okeys) * k // 4]) for k in (1, 2, 3)]
    step = report["partitions"] = dict(new_step(), bounds=b)
    t0 = time.perf_counter()
    s.execute(f"create table li_part ({_COPY_DDL}) partition by range (l_orderkey) ("
              f"partition p0 values less than ({b[0]}), partition p1 values less than "
              f"({b[1]}), partition p2 values less than ({b[2]}), "
              "partition p3 values less than maxvalue)")
    arrays, strings = copy_columns(np, model)
    part = cat.table("test", "li_part")
    part.insert_columns(arrays, strings=strings)
    step["load_s"] = time.perf_counter() - t0
    p0 = model_where(model, model.table("test", "lineitem").data["l_orderkey"] < b[0])
    cases = [
        ("q1_p0", Q["q1"][0].replace("from lineitem", "from li_part").replace(
            "interval '90' day", f"interval '90' day and l_orderkey < {b[0]}"), p0),
        ("q6_p0", Q["q6"][0].replace("from lineitem", "from li_part")
         + f"  and l_orderkey < {b[0]}\n", p0),
        ("q3", Q["q3"][0].replace("lineitem", "li_part"), model),
    ]
    for qname, sql, m in cases:
        plan = planned(s, sql)
        want = plan_fragments(plan, s._plan_capacity(plan))
        parts = [n for n in _walk(plan) if isinstance(n, PPartitionScan)]
        if qname != "q3" and (len(parts) != 1 or parts[0].part_names != ("p0",)):
            raise AssertionError(f"{qname} did not plan a PartitionScan of p0:\n"
                                 f"{explain_text(plan)}")
        agg_chunks[0] = 0
        rows, c, dt = run_query(s, mods, sql)
        step_add(step, c)
        check_path(qname, c, agg_chunks[0], want)
        if qname == "q1_p0":
            check_q1(np, rows, numpy_q1(np, m.table("test", "lineitem")))
        elif qname == "q6_p0":
            got = _scaled(rows[0][0])
            if got != numpy_q6(np, m.table("test", "lineitem")):
                raise AssertionError(f"partitioned Q6 {rows} vs numpy")
        else:
            check_join_rows("q3", rows, numpy_q3(np, m), {1})
        if qname != "q3" and (not c["launches"]["segagg"]
                              or c["launches"]["segagg"] != agg_chunks[0]):
            raise AssertionError(f"{qname}: tidb_segagg {c['launches']['segagg']} over "
                                 f"{agg_chunks[0]} aggregated chunks")
        step["queries"][qname] = {"s": dt, "launches": c["launches"],
                                  "aggregated_chunks": agg_chunks[0],
                                  "routes": c["routes"], "fused": c["fused"],
                                  "plan": explain_text(plan)}
        log(f"schema partitions {qname}: {dt:.3f} s; launches {c['launches']}; "
            f"aggregated chunks {agg_chunks[0]}; fused {c['fused']}; equal numpy")
    s.execute("drop table li_part")
    s.execute("create table part_bound (k bigint) partition by range (k) "
              "(partition p0 values less than (10), partition p1 values less than (20))")
    step["refused"] = expect_refusal(s, "insert into part_bound values (5), (25)",
                                     "no partition for value")
    if s.query("select count(*) from part_bound") != [(0,)]:
        raise AssertionError("a refused partition insert left rows")
    s.execute("drop table part_bound")
    log(f"schema partitions: bounds {b}, load {step['load_s']:.3f} s; the row past a "
        f"bound-less RANGE refused ({step['refused']})")

    # -- constraints and a generated column -----------------------------------
    step = report["constraints"] = new_step()
    s.execute(f"create table li_cons ({_COPY_DDL}, l_disc_price decimal(15,4) "
              "generated always as (l_extendedprice * (1 - l_discount)) stored, "
              "check (l_discount between 0.00 and 0.10), "
              "check (l_quantity between 1 and 50), "
              "foreign key (l_orderkey) references orders (o_orderkey))")
    cons = cat.table("test", "li_cons")
    acc = {}
    t0 = time.perf_counter()
    with timing(Table, "_check_fk_parents", acc, "fk_s"), \
            timing(Table, "_check_row_constraints", acc, "check_s"), \
            timing(Table, "_apply_generated", acc, "generated_s"):
        cons.insert_columns(arrays, strings=strings)
    step["load"] = dict(acc, load_s=time.perf_counter() - t0, rows=cons.n)
    sql = ("select l_returnflag, l_linestatus, sum(l_disc_price) from li_cons "
           "where l_shipdate <= date '1998-12-01' - interval '90' day "
           "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus")
    rows, c, dt = run_query(s, mods, sql)
    step_add(step, c)
    want = [(w[0], w[1], w[4]) for w in numpy_q1(np, model.table("test", "lineitem"))]
    if [(r[0], r[1], _scaled(r[2])) for r in rows] != want or not c["launches"]["segagg"]:
        raise AssertionError(f"sum of the generated column {rows} vs numpy {want}; {c}")
    step["queries"]["generated_sum"] = {"s": dt, "launches": c["launches"],
                                        "fused": c["fused"]}
    log(f"schema constraints: load of {cons.n} rows {step['load']['load_s']:.3f} s (FK "
        f"{acc.get('fk_s', 0):.3f} s, CHECK {acc.get('check_s', 0):.3f} s, generated "
        f"{acc.get('generated_s', 0):.3f} s); sum(l_disc_price) by group equals Q1's "
        f"sum_disc_price from numpy ({dt:.3f} s, launches {c['launches']})")
    # RF1 into the copy: the new orders first, then their lineitems (no
    # auto-analyze: the refresh phase times it; here the copy's first
    # commit would analyze its 6M rows, 13 s)
    s.execute("set tidb_enable_auto_analyze = 0")
    new = rf.rf1(cat, sf, seed=11)
    cols = list(_COPY_COLS)
    lines = new["lineitem"]
    stmts = rf.insert_statements(o, new["orders"])
    vals = ["(" + ", ".join(rf._literal(li, li.schema.col(c), lines[c][i]) for c in cols)
            + ")" for i in range(len(lines["l_orderkey"]))]
    stmts += [f"insert into li_cons ({', '.join(cols)}) values " + ", ".join(vals[i:i + 500])
              for i in range(0, len(vals), 500)]
    for q in stmts:
        timed(step, s, mods, q, q[:40])
    n_new = len(vals)
    good = dict(zip(cols, vals[0][1:-1].split(", ")))
    bad_disc = dict(good, l_discount="0.20", l_linenumber="99")
    orphan = dict(good, l_orderkey=str(int(okeys[-1]) + 10_000_000), l_linenumber="98")
    ins = f"insert into li_cons ({', '.join(cols)}) values "
    step["refused"] = [
        expect_refusal(s, ins + "(" + ", ".join(bad_disc[c] for c in cols) + ")", "CHECK"),
        expect_refusal(s, ins + "(" + ", ".join(orphan[c] for c in cols) + ")",
                       "foreign key"),
    ]
    keys = rf.rf2_keys(cat, sf)
    klist = ", ".join(str(k) for k in keys)
    step["refused"].append(expect_refusal(
        s, f"delete from orders where o_orderkey in ({klist})", "referenced by"))
    for q in (f"delete from lineitem where l_orderkey in ({klist})",
              f"delete from li_cons where l_orderkey in ({klist})",
              f"delete from orders where o_orderkey in ({klist})"):
        timed(step, s, mods, q, q[:40])
    if cons.live_rows != len(model.table("test", "lineitem").data["l_orderkey"]) + n_new \
            - int(np.isin(model.table("test", "lineitem").data["l_orderkey"], keys).sum()):
        raise AssertionError(f"li_cons holds {cons.live_rows} rows after RF1 and RF2")
    s.execute("set tidb_enable_auto_analyze = 1")
    log(f"schema constraints: RF1 ({n_new} lineitems) passed the parent checks; refused "
        f"{step['refused']}; RF2 in TPC-H's order passed; statements "
        f"{[(x['sql'], round(x['s'], 3)) for x in step['statements']]}")
    s.execute("drop table li_cons")

    # -- ALTER TABLE on orders, a savepoint inside RF1, FOR UPDATE ------------
    step = report["ddl"] = new_step()
    model = ArrayModel(np, cat)  # RF1's orders in, RF2's orders and lineitems out
    for q in ("alter table orders add column o_flag bigint default 1",
              "alter table orders modify column o_flag decimal(12,2)",
              "alter table orders drop column o_flag"):
        timed(step, s, mods, q)
        rows, c, dt = run_query(s, mods, Q["q3"][0])
        step_add(step, c)
        check_join_rows("q3", rows, numpy_q3(np, model), {1})
        step["queries"][q] = {"s": dt, "launches": c["launches"]}
        if q.startswith("alter table orders add"):
            if s.query("select count(*), sum(o_flag) from orders") != [(o.live_rows,
                                                                       o.live_rows)]:
                raise AssertionError("ADD COLUMN did not fill its default")
    new = rf.rf1(cat, sf, seed=13)
    n_o, n_l = o.live_rows, li.live_rows
    timed(step, s, mods, "begin")
    for q in rf.insert_statements(o, new["orders"]):
        timed(step, s, mods, q, q[:40])
    timed(step, s, mods, "savepoint rf1_lines")
    for q in rf.insert_statements(li, new["lineitem"]):
        timed(step, s, mods, q, q[:40])
    grown = model.copy()
    grown.append(new)
    rows, c, dt = run_query(s, mods, Q["q1"][0])
    step_add(step, c)
    check_q1(np, rows, numpy_q1(np, grown.table("test", "lineitem")))
    timed(step, s, mods, "rollback to savepoint rf1_lines")
    rows, c, dt = run_query(s, mods, Q["q1"][0])
    step_add(step, c)
    check_q1(np, rows, numpy_q1(np, model.table("test", "lineitem")))
    timed(step, s, mods, "commit")
    if (o.live_rows, li.live_rows) != (n_o + len(new["orders"]["o_orderkey"]), n_l):
        raise AssertionError("the savepoint did not keep RF1's orders and drop its "
                             f"lineitems: {(o.live_rows, li.live_rows)}")
    step["savepoint"] = {"orders_kept": len(new["orders"]["o_orderkey"]),
                         "lineitems_rolled_back": len(new["lineitem"]["l_orderkey"])}
    k = int(okeys[len(okeys) // 3])
    other = Session(catalog=cat, device=s.device)
    s.execute("begin")
    locked = s.query(f"select o_orderkey, o_totalprice from orders where o_orderkey = {k} "
                     "for update")
    upd = f"update orders set o_totalprice = o_totalprice + 1 where o_orderkey = {k}"
    step["for_update"] = [
        expect_refusal(other, upd, "locked by another transaction"),
        expect_refusal(other, f"select * from orders where o_orderkey = {k} for update "
                       "nowait", "Lock wait timeout"),
    ]
    s.execute("commit")
    other.execute(upd)
    after = s.query(f"select o_orderkey, o_totalprice from orders where o_orderkey = {k}")
    if len(locked) != 1 or _scaled(after[0][1]) != _scaled(locked[0][1]) + 100:
        raise AssertionError(f"FOR UPDATE: {locked} then {after}")
    log(f"schema ddl: ADD/MODIFY/DROP COLUMN on orders, Q3 equal numpy after each "
        f"({[round(v['s'], 3) for v in step['queries'].values()]} s); the savepoint kept "
        f"RF1's orders and rolled back its lineitems; FOR UPDATE refused "
        f"{step['for_update']}; the UPDATE passed after COMMIT")
    return report


# -- statistics, EXPLAIN ANALYZE, windows and views at SF1 ---------------------

TPCH_TABLES = ("lineitem", "orders", "partsupp", "part", "customer", "supplier",
               "nation", "region")


def stats_fresh(t) -> bool:
    """The table carries statistics collected at its current version."""
    st = getattr(t, "stats", None)
    return st is not None and st.version == t.version


def five_plans(s) -> dict:
    """The plans of Q1, Q6, Q3, Q5 and Q18 as the planner makes them now."""
    from tidb_tpu_torch.planner.physical import explain_text
    from tidb_tpu_torch.storage.tpch_queries import Q

    return {q: explain_text(planned(s, Q[q][0])) for q in REFRESH_QUERIES}


def plan_shape(text: str) -> list:
    """An explain_text without its estRows column: the operators, their
    order and their info."""
    lines = text.split("\n")
    e = lines[0].index("estRows")
    return [line[:e].rstrip() + " " + " ".join(line[e:].split()[1:]) for line in lines[1:]]


def log_plans(label, plans, before=None):
    for q, text in plans.items():
        moved = "" if before is None else (
            " (same operators)" if plan_shape(before[q]) == plan_shape(text)
            else " (operators changed)")
        log(f"{label} plan of {q}{moved}:\n{text}")


@contextlib.contextmanager
def timed_analyze(acc: dict):
    """Time every analyze_table call (auto-analyze's included) by table."""
    from tidb_tpu_torch import statistics as stats_mod

    real = stats_mod.analyze_table

    def timed_call(t):
        t0 = time.perf_counter()
        try:
            return real(t)
        finally:
            acc[t.schema.name] = acc.get(t.schema.name, 0.0) + time.perf_counter() - t0

    stats_mod.analyze_table = timed_call
    try:
        yield acc
    finally:
        stats_mod.analyze_table = real


@contextlib.contextmanager
def scan_stage_bytes(counter: list):
    """Count the bytes the classic scan copies host->device (its `stage`),
    independently of utils.dispatch."""
    from tidb_tpu_torch.executor import scan as scan_mod

    real = scan_mod.stage

    def counting(host, cap, dtype, device):
        out = real(host, cap, dtype, device)
        if out.is_cuda:
            counter[0] += len(host) * host.dtype.itemsize
        return out

    scan_mod.stage = counting
    try:
        yield counter
    finally:
        scan_mod.stage = real


def explain_analyze(s, mods, sql: str, n_rows: int, agg_chunks) -> dict:
    """EXPLAIN ANALYZE of one query with the launch, pipeline and staging
    counters set to 0 just before it and read just after. The root's
    actRows must equal the query's row count, the operators' own
    dispatches must add up to the kernels' launches in the statement, and
    the profile line's xfer_bytes to the bytes the fused pipeline and the
    classic scan staged."""
    from tidb_tpu_torch.utils import dispatch

    seg_mod, hp, jk, pl, st, agg_mod = mods
    seg_mod.reset_launches()
    hp.reset_launches()
    jk.reset_routes()
    pl.reset_counters()
    agg_chunks[0] = 0
    x0 = dispatch.xfer_bytes()
    t0 = time.perf_counter()
    with scan_stage_bytes([0]) as classic:
        res = s.execute("explain analyze " + sql)
    dt = time.perf_counter() - t0
    launches = launches_of((seg_mod, hp))
    lines = [r[0] for r in res.rows]
    head = lines[0]
    act = int(lines[1][head.index("actRows"):head.index("drift")])
    own = sum(int(n) for n in re.findall(r"dispatches:(\d+)", "\n".join(lines[1:-1])))
    prof = dict(kv.split("=") for kv in lines[-1].split()[1:])
    staged = pl.PIPELINE_PREFETCH_BYTES["h2d"] + classic[0]
    out = {"s": dt, "text": "\n".join(lines), "act_rows": act, "rows": n_rows,
           "dispatches": own, "launches": launches, "profile": prof,
           "xfer_bytes": dispatch.xfer_bytes() - x0, "staged_bytes": staged,
           "aggregated_chunks": agg_chunks[0], "routes": dict(jk.PROBE_ROUTES)}
    if act != n_rows:
        raise AssertionError(f"EXPLAIN ANALYZE root actRows {act}, the query gives "
                             f"{n_rows} rows")
    if own != sum(launches.values()):
        raise AssertionError(f"EXPLAIN ANALYZE dispatches add up to {own}, the kernels "
                             f"launched {launches}")
    if int(prof["xfer_bytes"]) != staged or out["xfer_bytes"] != staged:
        raise AssertionError(f"EXPLAIN ANALYZE xfer_bytes {prof['xfer_bytes']}, staged "
                             f"{staged} (pipeline {pl.PIPELINE_PREFETCH_BYTES}, classic "
                             f"scan {classic[0]})")
    if launches["segagg"] != agg_chunks[0]:
        raise AssertionError(f"tidb_segagg launched {launches['segagg']} times over "
                             f"{agg_chunks[0]} aggregated chunks")
    if launches["probe_count"] != sum(out["routes"].values()):
        raise AssertionError(f"probe_count {launches['probe_count']} over "
                             f"{out['routes']} probe chunks")
    return out


def phase_stats(torch, np, s, mods) -> dict:
    """ANALYZE TABLE of the eight TPC-H tables at SF1, timed per table; Q1,
    Q6, Q3, Q5 and Q18 under the analyzed plans against numpy over the
    tables' live rows (warm median of 3; one profiled run of Q6: device
    busy time; STATS_UNPROFILED are not profiled);
    EXPLAIN ANALYZE of Q1 (the device buffer cache cleared
    first, so it stages), Q3 and Q18 with their counters checked."""
    from tidb_tpu_torch.storage.tpch_queries import Q

    seg_mod, hp, jk, pl, st, agg_mod = mods
    cat = s.catalog
    report = {"analyze_s": {}, "queries": {}, "explain_analyze": {}}
    t_phase = time.perf_counter()
    plans_before = five_plans(s)
    for name in TPCH_TABLES:
        t = cat.table("test", name)
        t0 = time.perf_counter()
        s.execute(f"analyze table {name}")
        report["analyze_s"][name] = time.perf_counter() - t0
        if not stats_fresh(t) or t.stats.n_rows != t.live_rows or t.modify_count:
            raise AssertionError(f"ANALYZE {name} left stats {t.stats and t.stats.n_rows} "
                                 f"for {t.live_rows} live rows")
        log(f"stats: ANALYZE TABLE {name} ({t.live_rows} rows, "
            f"{len(t.schema.columns)} columns): {report['analyze_s'][name]:.3f} s")
    report["plans"] = plans = five_plans(s)
    report["plans_changed"] = [q for q in plans
                               if plan_shape(plans[q]) != plan_shape(plans_before[q])]
    log_plans("stats: analyzed", plans, plans_before)
    model = ArrayModel(np, cat)
    agg_chunks = count_segment_chunks()
    res = {}
    for q in REFRESH_QUERIES:
        # the first run and three warm ones, each with the counters set to
        # 0 just before it and read just after (run_query), then one
        # profiled run; the launches of all five count
        runs, launches = [], {}
        for i in range(1 + WARM_RUNS):
            agg_chunks[0] = 0
            rows, c, dt = run_query(s, mods, Q[q][0])
            if c["launches"]["segagg"] != agg_chunks[0] or (
                    c["launches"]["probe_count"] != sum(c["routes"].values())):
                raise AssertionError(f"stats {q}: launches {c['launches']} over "
                                     f"{agg_chunks[0]} aggregated chunks, routes "
                                     f"{c['routes']}")
            if i == 0:
                res[q], first = rows, (c, dt)
            else:
                runs.append(dt)
                if rows != res[q]:
                    raise AssertionError(f"stats {q}: a warm run differs from the first")
            for k, v in c["launches"].items():
                launches[k] = launches.get(k, 0) + v
        prof, prof_s = {"device_busy_us": None, "idle_share": None}, None
        if q not in STATS_UNPROFILED:
            seg_mod.reset_launches()
            hp.reset_launches()
            t0 = time.perf_counter()
            prof = profile_query(torch, s, Q[q][0])
            prof_s = time.perf_counter() - t0
            for k, v in launches_of(mods).items():
                launches[k] += v
        c, dt = first
        busy = None if prof["device_busy_us"] is None else prof["device_busy_us"] / 1e3
        report["queries"][q] = {"first_s": dt, "warm_median_s": statistics.median(runs),
                                "runs_s": runs, "launches": launches,
                                "first_run_launches": c["launches"],
                                "routes": c["routes"], "fused": c["fused"],
                                "generic_runs": c["generic_runs"],
                                "segments": c["segments"], "device_busy_ms": busy,
                                "idle_share": prof["idle_share"], "profile_s": prof_s}
        prof_note = ("not profiled" if prof_s is None else
                     f"the profiled run {prof_s:.1f} s; device busy {busy:.3f} ms, "
                     f"idle {prof['idle_share']:.3f}")
        log(f"stats {q} (+{time.perf_counter() - t_phase:.1f} s into the phase; "
            f"{prof_note}): first {dt:.3f} s, warm median of {WARM_RUNS} "
            f"{statistics.median(runs) * 1e3:.3f} ms (runs {runs}); "
            f"first run's launches {c['launches']}; routes {c['routes']}; segments "
            f"{c['segments']}; fused {c['fused']}; device generic {c['generic_runs']}")
    check_five(np, res, model, "analyzed")
    log(f"stats: Q1, Q6, Q3, Q5 and Q18 under the analyzed plans equal numpy (+"
        f"{time.perf_counter() - t_phase:.1f} s into the phase)")
    pl.DEVICE_CACHE.clear()  # Q1 stages its batches again under EXPLAIN ANALYZE
    for q in ("q1", "q3", "q18"):
        ea = explain_analyze(s, mods, Q[q][0], len(res[q]), agg_chunks)
        report["explain_analyze"][q] = ea
        log(f"stats: EXPLAIN ANALYZE {q} in {ea['s']:.3f} s; root actRows {ea['act_rows']}"
            f" = rows; dispatches {ea['dispatches']} = launches {ea['launches']}; "
            f"xfer_bytes {ea['xfer_bytes']} = staged {ea['staged_bytes']}:\n{ea['text']}")
    if not report["explain_analyze"]["q1"]["xfer_bytes"]:
        raise AssertionError("EXPLAIN ANALYZE of Q1 staged nothing after the cache clear")
    launches = {}
    for part in list(report["queries"].values()) + list(report["explain_analyze"].values()):
        for k, v in part["launches"].items():
            launches[k] = launches.get(k, 0) + v
    report["launches"] = launches
    if not launches.get("segagg") or not launches.get("probe_count"):
        raise AssertionError(f"the stats phase missed a kernel of its path: {launches}")
    if launches.get("hash_probe") or launches.get("segsum_count") \
            or launches.get("segsum_i64"):
        raise AssertionError(f"the stats phase launched an off-path entry: {launches}")
    return report


# the window queries of phase_window over orders: (name, SQL); each ORDER BY
# that row_number, lag and the ROWS frame read ends in the unique
# o_orderkey, so every value is defined by the data alone
# the window queries read the orders up to this quantile of o_orderkey
# (every order until the SF10 phase took its share of the time limit)
WINDOW_SHARE = 0.25
WINDOW_SQL = [
    ("row_number_rank",
     "select o_orderkey, row_number() over (partition by o_custkey order by "
     "o_totalprice desc, o_orderkey) as rn, rank() over (partition by o_custkey "
     "order by o_totalprice desc) as rk from orders"),
    ("running_sum",
     "select o_orderkey, sum(o_totalprice) over (partition by o_custkey order by "
     "o_orderdate) from orders"),
    ("lag",
     "select o_orderkey, lag(o_totalprice) over (partition by o_custkey order by "
     "o_orderdate, o_orderkey) from orders"),
    ("avg_rows_frame",
     "select o_orderkey, avg(o_totalprice) over (partition by o_custkey order by "
     "o_orderdate, o_orderkey rows between 2 preceding and current row) from orders"),
]


def _partition_walk(np, keys):
    """Over rows sorted by `keys` (a lexsort tuple, last key primary):
    (perm, partition start of each sorted row, new-partition flags); the
    partition is the primary key."""
    perm = np.lexsort(keys)
    part = keys[-1][perm]
    new = np.ones(len(perm), dtype=bool)
    new[1:] = part[1:] != part[:-1]
    starts = np.flatnonzero(new)
    return perm, starts[np.cumsum(new) - 1], new


def numpy_windows(np, ok, ck, tp, od) -> dict:
    """The four window queries evaluated by numpy alone, each as arrays
    aligned with o_orderkey ascending (decimals as scaled ints)."""
    n = len(ok)
    idx = np.arange(n)
    out = {}
    perm, pstart, new = _partition_walk(np, (ok, -tp, ck))
    rn = np.empty(n, dtype=np.int64)
    rn[perm] = idx - pstart + 1
    tie = new.copy()
    tie[1:] |= tp[perm][1:] != tp[perm][:-1]
    tstart = np.flatnonzero(tie)[np.cumsum(tie) - 1]
    rk = np.empty(n, dtype=np.int64)
    rk[perm] = tstart - pstart + 1
    out["row_number_rank"] = (rn, rk)
    perm, pstart, new = _partition_walk(np, (od, ck))
    v = tp[perm]
    cs = np.cumsum(v)
    run = cs - (cs[pstart] - v[pstart])
    tie = new.copy()
    tie[1:] |= od[perm][1:] != od[perm][:-1]
    tstarts = np.flatnonzero(tie)
    tlast = np.append(tstarts[1:] - 1, n - 1)[np.cumsum(tie) - 1]
    rs = np.empty(n, dtype=np.int64)
    rs[perm] = run[tlast]
    out["running_sum"] = (rs,)
    perm, pstart, new = _partition_walk(np, (ok, od, ck))
    v = tp[perm]
    prev = np.where(new, 0, np.roll(v, 1))
    lag = np.empty(n, dtype=np.int64)
    lag[perm] = prev
    has = np.empty(n, dtype=bool)
    has[perm] = ~new
    out["lag"] = (lag, has)
    cs = np.concatenate(([0], np.cumsum(v)))
    lo = np.maximum(idx - 2, pstart)
    avg = (cs[idx + 1] - cs[lo]) / (idx - lo + 1) / 100.0
    av = np.empty(n)
    av[perm] = avg
    out["avg_rows_frame"] = (av,)
    order = np.argsort(ok)
    return {k: tuple(a[order] for a in arrs) for k, arrs in out.items()}


def check_window(np, name, rows, want):
    """Port rows (o_orderkey, value...) against numpy's arrays."""
    rows = sorted(rows)
    if len(rows) != len(want[0]):
        raise AssertionError(f"window {name}: {len(rows)} rows, numpy has {len(want[0])}")
    if name == "row_number_rank":
        got = np.array([r[1:] for r in rows], dtype=np.int64)
        ok = np.array_equal(got[:, 0], want[0]) and np.array_equal(got[:, 1], want[1])
    elif name == "running_sum":
        ok = np.array_equal(np.array([_scaled(r[1]) for r in rows]), want[0])
    elif name == "lag":
        has = np.array([r[1] is not None for r in rows])
        vals = np.array([_scaled(r[1]) if r[1] is not None else 0 for r in rows])
        ok = np.array_equal(has, want[1]) and np.array_equal(vals, want[0])
    else:
        got = np.array([r[1] for r in rows], dtype=np.float64)
        ok = bool(np.all(np.abs(got - want[0]) <= 1e-12 * np.abs(want[0])))
    if not ok:
        raise AssertionError(f"window {name} differs from numpy")


# the official TPC-H Q15 (clause 2.4.15): a view, the query, DROP VIEW
Q15_VIEW = ("create view revenue0 (supplier_no, total_revenue) as "
            "select l_suppkey, sum(l_extendedprice * (1 - l_discount)) from lineitem "
            "where l_shipdate >= date '1996-01-01' "
            "and l_shipdate < date '1996-01-01' + interval '3' month "
            "group by l_suppkey",
            "select s_suppkey, s_name, s_address, s_phone, total_revenue "
            "from supplier, revenue0 where s_suppkey = supplier_no "
            "and total_revenue = (select max(total_revenue) from revenue0) "
            "order by s_suppkey",
            "drop view revenue0")


def numpy_q15(np, model, cat):
    """TPC-H Q15 by numpy: (s_suppkey, s_name, s_address, s_phone,
    revenue scaled 4) of the suppliers with the top revenue."""
    li = model.table("test", "lineitem")
    ship, supp, ext, disc = (li.data[c] for c in ("l_shipdate", "l_suppkey",
                                                  "l_extendedprice", "l_discount"))
    m = (ship >= _days(np, "1996-01-01")) & (ship < _days(np, "1996-04-01"))
    uniq, rev = _group_sum(np, supp[m], ext[m] * (100 - disc[m]))
    top = uniq[rev == rev.max()]
    su = cat.table("test", "supplier")
    key = su.data["s_suppkey"][:su.n]
    out = []
    for k in sorted(top.tolist()):
        i = int(np.flatnonzero(key == k)[0])
        strs = tuple(su.dicts[c].values[int(su.data[c][i])]
                     for c in ("s_name", "s_address", "s_phone"))
        out.append((k, *strs, int(rev.max())))
    return out


def phase_window(np, s, mods) -> dict:
    """Window functions over orders (the live rows up to WINDOW_SHARE of
    o_orderkey) and the official
    TPC-H Q15 through a view, each against numpy; one line each of SHOW
    TABLES, SHOW CREATE TABLE lineitem and SHOW INDEX FROM orders."""
    from tidb_tpu_torch.storage.tpch_queries import Q

    cat = s.catalog
    model = ArrayModel(np, cat)
    o = model.table("test", "orders")
    okeys = o.data["o_orderkey"]
    kmax = int(np.sort(okeys)[int(len(okeys) * WINDOW_SHARE) - 1])
    m = okeys <= kmax
    want = numpy_windows(np, *(o.data[c][m].astype(np.int64) for c in (
        "o_orderkey", "o_custkey", "o_totalprice", "o_orderdate")))
    report = {"windows": {}, "launches": {}, "key_max": kmax}
    for name, sql in WINDOW_SQL:
        rows, c, dt = run_query(s, mods, f"{sql} where o_orderkey <= {kmax}")
        check_window(np, name, rows, want[name])
        for k, v in c["launches"].items():
            report["launches"][k] = report["launches"].get(k, 0) + v
        report["windows"][name] = {"s": dt, "rows": len(rows), "launches": c["launches"]}
        log(f"window {name}: {len(rows)} rows equal numpy in {dt:.3f} s; launches "
            f"{c['launches']}")
    seg_mod, hp, jk = mods[0], mods[1], mods[2]
    seg_mod.reset_launches()
    hp.reset_launches()
    jk.reset_routes()
    t0 = time.perf_counter()
    s.execute(Q15_VIEW[0])
    view_rows = s.query(Q15_VIEW[1])
    s.execute(Q15_VIEW[2])
    dt = time.perf_counter() - t0
    launched = launches_of(mods)
    routes = dict(jk.PROBE_ROUTES)
    inline_rows, c, _dt = run_query(s, mods, Q["q15"][0])
    for counts in (launched, c["launches"]):
        for k, v in counts.items():
            report["launches"][k] = report["launches"].get(k, 0) + v
    want15 = numpy_q15(np, model, cat)
    got15 = [(r[0], r[1], r[2], r[3], _scaled(r[4])) for r in view_rows]
    if got15 != want15 or view_rows != inline_rows:
        raise AssertionError(f"Q15 through its view {view_rows} vs numpy {want15}, "
                             f"inlined {inline_rows}")
    if cat.view("test", "revenue0") is not None:
        raise AssertionError("DROP VIEW revenue0 left the view")
    report["q15_view"] = {"s": dt, "rows": view_rows, "launches": launched,
                          "routes": routes, "inline_launches": c["launches"]}
    log(f"window: the official Q15 (CREATE VIEW revenue0, the query, DROP VIEW) in "
        f"{dt:.3f} s equals numpy and the inlined Q15: {view_rows}; launches {launched}")
    shows = {}
    for sql in ("show tables", "show create table lineitem", "show index from orders"):
        rows = s.query(sql)
        shows[sql] = rows
        log(f"{sql}: " + " | ".join(" ".join(str(v) for v in r).replace("\n", " ")
                                     for r in rows))
    if ("lineitem",) not in shows["show tables"] or \
            "CLUSTER BY (`l_shipdate`)" not in shows["show create table lineitem"][0][1]:
        raise AssertionError(f"SHOW gave {shows}")
    report["show"] = shows
    return report


# -- the storage phase: the delta engine, CTAS, LIKE, OUTFILE and LOAD
# DATA, TEMPORARY over the wire, information_schema, DROP DATABASE ---------

STORAGE_DB = "stage"
LOAD_ROWS = 100_000  # orders' rows through OUTFILE and LOAD DATA (300,000 before SF10)
# the delta engine's INSERT ... SELECT and the CTAS read the orders (and
# their lineitems) up to this quantile of o_orderkey: all of them took 36
# and 14 s of the SF1 script before the SF10 phase took its share
STORAGE_SHARE = 0.25
# the trickle's INSERT counts (10,000 and 1,000 before the planner phase
# took its share of the script's time limit, 5,000 and 500 before the
# DCN phase did: the memtable's 4,096-row flush is no longer reached on
# the card)
TRICKLE, TRICKLE_COLUMNAR, TEMP_ROWS = 250, 125, 1_000
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
STORAGE_AGG = ("select o_orderpriority, count(*), sum(o_totalprice) from {t} "
               "group by o_orderpriority order by o_orderpriority")
CTAS_REV = (f"create table {STORAGE_DB}.rev as select l_orderkey, "
            "sum(l_extendedprice * (1 - l_discount)) as revenue from lineitem "
            "where l_orderkey <= {kmax} group by l_orderkey")
REV_JOIN = (f"select o_orderpriority, count(*), sum(revenue) from {STORAGE_DB}.rev "
            "join orders on l_orderkey = o_orderkey where o_orderdate < '1995-03-15' "
            "group by o_orderpriority order by o_orderpriority")


def no_key_ddl(s, src: str, dst: str, engine: str) -> str:
    """CREATE TABLE `dst` with `src`'s columns and no keys, CLUSTER BY or
    CHECKs, from SHOW CREATE TABLE: a keyed delta table writes through,
    and this one must buffer."""
    text = s.execute(f"show create table {src}").rows[0][1]
    keep = [ln for ln in text.splitlines()
            if not ln.strip().startswith(("PRIMARY KEY", "UNIQUE KEY", "KEY ",
                                          "CONSTRAINT", "CHECK", "CLUSTER BY",
                                          ") ENGINE"))]
    body = "\n".join(keep).replace(f"`{src}`", f"{dst}", 1).rstrip().rstrip(",")
    return body + f"\n) ENGINE={engine}"


def trickle_row(k: int) -> tuple:
    """One fresh orders row for key k: (sql values text, priority,
    scaled price, date days, custkey)."""
    prio = PRIORITIES[k % 5]
    cents = 100_000 + (k * 7919) % 900_000
    day = 9131 + k % 500  # 1995-01-01 onwards
    return prio, cents, day, 1 + k % 1000


def trickle_sql(np, table: str, k: int) -> str:
    prio, cents, day, cust = trickle_row(k)
    return (f"insert into {table} values ({k}, {cust}, 'O', {cents // 100}.{cents % 100:02d}, "
            f"'{_iso(np, day)}', '{prio}', 'Clerk#000000001', 0, 'trickle {k}')")


def numpy_priority_agg(np, o, extra_keys=(), key_max=None):
    """(priority, count, scaled price sum) over orders' live rows (those
    with o_orderkey <= `key_max`, when given) and the trickle rows of
    `extra_keys`."""
    n = o.n
    live = o.live_mask(0, n)
    if key_max is not None:
        live &= o.data["o_orderkey"][:n] <= key_max
    codes = o.data["o_orderpriority"][:n][live]
    price = o.data["o_totalprice"][:n][live].astype(np.int64)
    names = o.dicts["o_orderpriority"].values
    out = {}
    for code in np.unique(codes):
        m = codes == code
        out[names[int(code)]] = [int(m.sum()), int(price[m].sum())]
    for k in extra_keys:
        prio, cents, _d, _c = trickle_row(k)
        e = out.setdefault(prio, [0, 0])
        e[0] += 1
        e[1] += cents
    return [(p, c, s) for p, (c, s) in sorted(out.items())]


def check_priority_rows(label, got, want):
    g = [(p, c, _scaled(s)) for p, c, s in got]
    if g != want:
        raise AssertionError(f"storage {label}: {g} vs numpy {want}")


class StorageModel:
    """Tables for numpy_q3: orders (and lineitem) replaced by given rows,
    the rest the ArrayModel's or the catalog's own."""

    def __init__(self, base, orders, lineitem=None):
        self.base, self.over = base, {"orders": orders, "lineitem": lineitem}

    def table(self, db, name):
        return self.over.get(name) or self.base.table(db, name)


def orders_model(np, model, keys=(), rows=None):
    """The ArrayModel's live orders plus trickle rows for `keys`, or only
    the orders rows at `rows` (positions into the model's arrays)."""
    o = model.table("test", "orders")
    data = {c: a if rows is None else a[rows] for c, a in o.data.items()}
    if len(keys):
        extra = [trickle_row(int(k)) for k in keys]
        add = {"o_orderkey": np.asarray(keys, dtype=np.int64),
               "o_custkey": np.asarray([e[3] for e in extra], dtype=np.int64),
               "o_orderdate": np.asarray([e[2] for e in extra], dtype=np.int32),
               "o_shippriority": np.zeros(len(keys), dtype=np.int64),
               "o_totalprice": np.asarray([e[1] for e in extra], dtype=np.int64)}
        data = {c: np.concatenate([a, add[c].astype(a.dtype)]) for c, a in data.items()}
    return ModelTable(data, o.dicts)


def storage_step(name, t0, step, log_extra=""):
    step["s"] = time.perf_counter() - t0
    log(f"storage {name}: {step['s']:.3f} s{log_extra}")
    log(f"storage {name} launches: tidb_segagg {step['launches'].get('segagg', 0)}, "
        f"tidb_probe_count {step['launches'].get('probe_count', 0)}, off-path "
        f"{ {k: v for k, v in step['launches'].items() if k not in ('segagg', 'probe_count')} }")
    return step


def step_query(step, s, mods, sql, label):
    rows, c, dt = run_query(s, mods, sql)
    step_add(step, c)
    step["queries"][label] = {"s": dt, "rows": len(rows), "launches": c["launches"],
                              "routes": c["routes"], "fused": c["fused"]}
    return rows


def phase_storage(torch, np, s, mods) -> dict:
    """The storage phase on the SF1 catalog after phase_window (module
    docstring, phase 7). Every step fails the run on a wrong answer;
    returns the report."""
    import shutil
    import threading

    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.server.client import Client
    from tidb_tpu_torch.storage.tpch_queries import Q

    seg_mod, hp, jk, pl, st, agg_mod = mods
    cat = s.catalog
    db = STORAGE_DB
    rep = {"card": card_line(), "steps": {}}
    t_phase = time.perf_counter()
    s.execute(f"create database {db}")
    model = ArrayModel(np, cat)
    orders = cat.table("test", "orders")
    q3 = Q["q3"][0]
    if q3.count(" orders,") != 1:
        raise AssertionError("storage: Q3's FROM list changed")
    want_q3 = numpy_q3(np, model)

    # -- 1. the delta engine: trickle ingest into a reporting table --------
    step, t0 = new_step(), time.perf_counter()
    om_keys = model.table("test", "orders").data["o_orderkey"]
    kmax = int(np.sort(om_keys)[int(len(om_keys) * STORAGE_SHARE) - 1])
    s.execute(no_key_ddl(s, "orders", f"{db}.orders_d", "delta"))
    rec = timed(step, s, mods, f"insert into {db}.orders_d select * from orders "
                f"where o_orderkey <= {kmax}", "insert select")
    live_src = orders.live_mask(0, orders.n) & (orders.data["o_orderkey"][:orders.n] <= kmax)
    n_src = int(live_src.sum())
    td = cat.table(db, "orders_d")
    if td.engine != "delta" or td.maintenance_stats()[0] != n_src:
        raise AssertionError(f"storage delta: {td.engine} holds "
                             f"{td.maintenance_stats()[0]} rows, orders {n_src}")
    step["insert_select_s"] = rec["s"]
    step["insert_select_rows_per_s"] = n_src / rec["s"]
    base_key = int(orders.data["o_orderkey"][:orders.n].max()) + 1
    keys = np.arange(base_key, base_key + TRICKLE, dtype=np.int64)
    per = []
    for k in keys:
        t1 = time.perf_counter()
        s.execute(trickle_sql(np, f"{db}.orders_d", int(k)))
        per.append(time.perf_counter() - t1)
    buffered = td.buffered_rows
    if buffered == 0:
        raise AssertionError("storage delta: the trickle left nothing buffered")
    got = step_query(step, s, mods, STORAGE_AGG.format(t=f"{db}.orders_d"), "agg")
    if td.buffered_rows:
        raise AssertionError("storage delta: the read left rows buffered")
    check_priority_rows("delta agg", got, numpy_priority_agg(np, orders, keys, kmax))
    sql = q3.replace(" orders,", f" {db}.orders_d,")
    got = step_query(step, s, mods, sql, "q3")
    share = np.nonzero(om_keys <= kmax)[0]
    check_join_rows("storage q3 over orders_d", got,
                    numpy_q3(np, StorageModel(model, orders_model(np, model, keys, share))),
                    {1})
    # the same INSERTs into a columnar copy holding the same rows (filled
    # by the bulk path: only the per-statement time is compared)
    s.execute(no_key_ddl(s, "orders", f"{db}.orders_c", "columnar"))
    tc = cat.table(db, "orders_c")
    live = np.nonzero(live_src)[0]
    arrays, strings = {}, {}
    for c in orders.schema.columns:
        col = orders.data[c.name][live]
        if c.name in orders.dicts:
            vals = orders.dicts[c.name].values
            strings[c.name] = [vals[int(x)] for x in col]
        else:
            arrays[c.name] = np.asarray(col)
    tc.insert_columns(arrays, strings=strings)
    ckeys = keys[:TRICKLE_COLUMNAR]
    per_c = []
    for k in ckeys:
        t1 = time.perf_counter()
        s.execute(trickle_sql(np, f"{db}.orders_c", int(k)))
        per_c.append(time.perf_counter() - t1)
    got = step_query(step, s, mods, STORAGE_AGG.format(t=f"{db}.orders_c"), "agg columnar")
    check_priority_rows("columnar agg", got, numpy_priority_agg(np, orders, ckeys, kmax))
    step.update({"trickle": TRICKLE, "trickle_columnar": TRICKLE_COLUMNAR,
                 "buffered_before_read": buffered,
                 "insert_ms": {"delta_p50": _pct(per, 0.5) * 1e3,
                               "delta_mean": sum(per) / len(per) * 1e3,
                               "delta_p99": _pct(per, 0.99) * 1e3,
                               "columnar_p50": _pct(per_c, 0.5) * 1e3,
                               "columnar_mean": sum(per_c) / len(per_c) * 1e3,
                               "columnar_p99": _pct(per_c, 0.99) * 1e3}})
    im = step["insert_ms"]
    rep["steps"]["delta"] = storage_step(
        "delta", t0, step,
        f"; INSERT ... SELECT of {n_src} rows {rec['s']:.3f} s; {TRICKLE} single-row "
        f"INSERTs mean {im['delta_mean']:.3f} ms (p50 {im['delta_p50']:.3f}, p99 "
        f"{im['delta_p99']:.3f}), {buffered} buffered at the first read; columnar "
        f"copy {TRICKLE_COLUMNAR} INSERTs mean {im['columnar_mean']:.3f} ms (p50 "
        f"{im['columnar_p50']:.3f}, p99 {im['columnar_p99']:.3f}); the aggregation and "
        f"Q3 over orders_d equal numpy")

    # -- 2. CTAS and LIKE ----------------------------------------------------
    step, t0 = new_step(), time.perf_counter()
    rec = timed(step, s, mods, CTAS_REV.format(kmax=kmax), "ctas rev")
    li = model.table("test", "lineitem")
    lkey, ext, disc = (li.data[c] for c in ("l_orderkey", "l_extendedprice", "l_discount"))
    m = lkey <= kmax
    uniq, rev = _group_sum(np, lkey[m], ext[m] * (100 - disc[m]))  # scale 4
    trev = cat.table(db, "rev")
    if trev.live_rows != len(uniq):
        raise AssertionError(f"storage ctas: {trev.live_rows} rows, numpy {len(uniq)}")
    step["ctas_s"], step["ctas_rows"] = rec["s"], len(uniq)
    got = step_query(step, s, mods, REV_JOIN, "rev join")
    o = model.table("test", "orders")
    opos = _lookup(np, o.data["o_orderkey"], int(max(o.data["o_orderkey"].max(), uniq.max())))
    row = opos[uniq]
    keep = (row >= 0) & (o.data["o_orderdate"][np.maximum(row, 0)] < _days(np, "1995-03-15"))
    live_o = orders.live_mask(0, orders.n)
    prio_of = orders.data["o_orderpriority"][:orders.n][live_o]
    names = orders.dicts["o_orderpriority"].values
    want = {}
    for p_code, r in zip(prio_of[row[keep]], rev[keep]):
        e = want.setdefault(names[int(p_code)], [0, 0])
        e[0] += 1
        e[1] += int(r)
    want = [(p, c, v) for p, (c, v) in sorted(want.items())]
    check_priority_rows("ctas rev join", got, want)
    rec = timed(step, s, mods, f"create table {db}.orders_like like orders", "like")
    tl = cat.table(db, "orders_like")
    if (tl.engine != orders.engine or tl.n != 0
            or [(c.name, c.sql) for c in tl.checks] != [(c.name, c.sql) for c in orders.checks]
            or sorted(tl.indexes) != sorted(orders.indexes)
            or tl.schema.primary_key != orders.schema.primary_key):
        raise AssertionError("storage like: orders_like is not orders' structure")
    rep["steps"]["ctas_like"] = storage_step(
        "ctas_like", t0, step,
        f"; CTAS of {len(uniq)} rows {step['ctas_s']:.3f} s; its join with orders equals "
        f"numpy; LIKE copied engine {tl.engine}, {len(tl.checks)} CHECKs, indexes "
        f"{sorted(tl.indexes)}, no rows")

    # -- 3. OUTFILE and LOAD DATA --------------------------------------------
    # orders' first LOAD_ROWS keys (a depth cut: the whole table took 51 s
    # of host I/O at SF1); Q3 over the loaded copy against numpy over the
    # same keys, and over orders again (unchanged by the copy)
    step, t0 = new_step(), time.perf_counter()
    om = model.table("test", "orders")
    n_load = min(LOAD_ROWS, len(om.data["o_orderkey"]))
    lkmax = int(np.sort(om.data["o_orderkey"])[n_load - 1])
    out_dir = os.path.join("build", "chip_smoke_storage")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    path = os.path.abspath(os.path.join(out_dir, "orders.tsv"))
    try:
        t1 = time.perf_counter()
        rs = s.execute(f"select * from orders where o_orderkey <= {lkmax} "
                       f"into outfile '{path}'")
        out_s = time.perf_counter() - t1
        if rs.rows != [(n_load,)]:
            raise AssertionError(f"storage outfile: {rs.rows}, orders' head {n_load}")
        file_bytes = os.path.getsize(path)
        s.execute(f"create table {db}.orders_loaded like orders")
        t1 = time.perf_counter()
        rs = s.execute(f"load data infile '{path}' into table {db}.orders_loaded")
        load_s = time.perf_counter() - t1
        if rs.rows != [(n_load,)]:
            raise AssertionError(f"storage load: {rs.rows}, orders' head {n_load}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    got_loaded = step_query(step, s, mods, q3.replace(" orders,", f" {db}.orders_loaded,"),
                            "q3 loaded")
    got_orders = step_query(step, s, mods, q3, "q3")
    # numpy_q3 indexes orders by key: lineitem cut to the same keys
    li = model.table("test", "lineitem")
    lhead = li.data["l_orderkey"] <= lkmax
    load_model = StorageModel(model, orders_model(
        np, model, rows=np.nonzero(om.data["o_orderkey"] <= lkmax)[0]),
        ModelTable({c: a[lhead] for c, a in li.data.items()}, li.dicts))
    check_join_rows("storage q3 over orders_loaded", got_loaded, numpy_q3(np, load_model), {1})
    check_join_rows("storage q3 over orders", got_orders, want_q3, {1})
    step.update({"outfile_s": out_s, "load_s": load_s, "file_bytes": file_bytes,
                 "rows": n_load, "outfile_rows_per_s": n_load / out_s,
                 "load_rows_per_s": n_load / load_s})
    rep["steps"]["outfile_load"] = storage_step(
        "outfile_load", t0, step,
        f"; OUTFILE {n_load} rows ({file_bytes} B) {out_s:.3f} s = "
        f"{n_load / out_s:.1f} rows/s; LOAD DATA {load_s:.3f} s = {n_load / load_s:.1f} "
        f"rows/s; Q3 over orders_loaded equals numpy over the same keys, Q3 over orders "
        f"numpy")

    # -- 4. TEMPORARY over the wire ------------------------------------------
    step, t0 = new_step(), time.perf_counter()
    pl.DEVICE_CACHE.clear()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    srv = Server(catalog=cat, host="127.0.0.1", port=0, device="cuda")
    srv.start()
    c1 = c2 = None
    try:
        c1 = Client(port=srv.port, timeout=600)
        c2 = Client(port=srv.port, timeout=600)
        okeys = np.sort(model.table("test", "orders").data["o_orderkey"])
        kmax = int(okeys[TEMP_ROWS - 1])
        # a temp table shadows its name for every later statement of its
        # connection, so its rows come from a staging copy
        s.execute(f"create table {db}.orders_head as select * from orders "
                  f"where o_orderkey <= {kmax}")
        c1.execute("create temporary table orders like orders")
        c1.execute(f"insert into orders select * from {db}.orders_head")
        sess = next(p for p in cat.processes.values() if p.catalog._temp)
        temp = sess.catalog._temp[("test", "orders")]
        if temp.live_rows != TEMP_ROWS:
            raise AssertionError(f"storage temp: {temp.live_rows} rows")
        box = {}

        def permanent():
            box["rows"] = c2.query(q3)[1]

        th = threading.Thread(target=permanent)
        seg_mod.reset_launches()
        hp.reset_launches()
        th.start()
        rows1 = c1.query(q3)[1]
        th.join(600)
        step_add(step, {"launches": launches_of(mods)})
        # numpy_q3 indexes orders by key: lineitem cut to the same keys
        li = model.table("test", "lineitem")
        head = li.data["l_orderkey"] <= kmax
        temp_model = StorageModel(model, orders_model(
            np, model, rows=np.nonzero(model.table("test", "orders").data["o_orderkey"]
                                       <= kmax)[0]),
            ModelTable({c: a[head] for c, a in li.data.items()}, li.dicts))
        check_join_rows("storage temp q3", _typed("q3", rows1), numpy_q3(np, temp_model), {1})
        check_join_rows("storage permanent q3", _typed("q3", box["rows"]), want_q3, {1})
        cached_temp = sum(1 for e in pl.DEVICE_CACHE._entries.values()
                          if e["table"] is temp)
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        c1.close()
        c1 = None
        for _ in range(1000):
            if not sess.catalog._temp:
                break
            time.sleep(0.01)
        if sess.catalog._temp:
            raise AssertionError("storage temp: the disconnect left the temp table")
        n_orders = int(orders.live_mask(0, orders.n).sum())
        if c2.query("select count(*) from orders")[1] != [(str(n_orders),)]:
            raise AssertionError("storage temp: the permanent orders changed")
        torch.cuda.synchronize()
        mem2 = torch.cuda.memory_allocated()
        still = [e["nbytes"] for e in pl.DEVICE_CACHE._entries.values()
                 if e["table"] is temp]
        del temp
        step.update({"memory_allocated": {"before": mem0, "with_temp": mem1,
                                          "after_disconnect": mem2},
                     "cache_entries_of_temp": {"while_open": cached_temp,
                                               "after_disconnect": len(still),
                                               "bytes_after_disconnect": sum(still)}})

        # -- 5. information_schema, in process and over the wire ----------
        info = {}
        t5 = time.perf_counter()
        s.execute(f"analyze table {db}.orders_loaded")
        tables_sql = ("select table_schema, table_name, table_rows from "
                      "information_schema.tables where table_type = 'BASE TABLE' "
                      f"and table_schema in ('test', '{db}')")
        cols_sql = ("select table_name, count(*) from information_schema.columns "
                    f"where table_schema = '{db}' group by table_name")
        stat_sql = ("select index_name, seq_in_index, column_name, non_unique from "
                    "information_schema.statistics where table_schema = "
                    f"'{db}' and table_name = 'orders_loaded'")
        proc_sql = "select id, user from information_schema.processlist"
        summ_sql = ("select exec_count from information_schema.statements_summary "
                    "where digest_text like '%orders_d%group by%'")
        for label, sql in (("tables", tables_sql), ("columns", cols_sql),
                           ("statistics", stat_sql), ("processlist", proc_sql),
                           ("statements_summary", summ_sql)):
            t1 = time.perf_counter()
            mine = s.query(sql)
            t2 = time.perf_counter()
            wire = c2.query(sql)[1]
            t3 = time.perf_counter()
            info[label] = {"rows": len(mine), "in_process_s": t2 - t1, "wire_s": t3 - t2}
            if label == "processlist":
                ids = {r[0] for r in mine}
                if s.conn_id not in ids or {int(r[0]) for r in wire} != ids:
                    raise AssertionError(f"storage processlist: {mine} / {wire}")
                continue
            as_text = sorted(tuple(None if v is None else str(v) for v in r) for r in mine)
            if as_text != sorted(wire):
                raise AssertionError(f"storage {label}: wire rows differ from in process")
            if label == "tables":
                for dbn, tn, n in mine:
                    if n != cat.table(dbn, tn).live_rows:
                        raise AssertionError(f"storage tables: {dbn}.{tn} {n} rows")
                if (db, "orders_d", n_src + TRICKLE) not in mine:
                    raise AssertionError(f"storage tables: orders_d missing from {mine}")
            elif label == "columns":
                for tn, n in mine:
                    if n != len(cat.table(db, tn).schema.columns):
                        raise AssertionError(f"storage columns: {tn} has {n}")
            elif label == "statistics":
                if sorted(mine) != [("PRIMARY", 1, "o_orderkey", 0)]:
                    raise AssertionError(f"storage statistics: {mine}")
            elif not mine or mine[0][0] < 1:
                raise AssertionError(f"storage statements_summary: {mine}")
        step["info_schema"] = info
        step["info_schema_s"] = time.perf_counter() - t5
    finally:
        for c in (c1, c2):
            if c is not None:
                c.close()
        srv.shutdown(drain=True)
    mc = step["memory_allocated"]
    rep["steps"]["temporary_info_schema"] = storage_step(
        "temporary_info_schema", t0, step,
        f"; a temp orders of {TEMP_ROWS} rows read by its connection's Q3 while another "
        f"read the permanent one, both equal numpy; dropped at disconnect; "
        f"memory_allocated {mc['before']} B before, {mc['with_temp']} B with it, "
        f"{mc['after_disconnect']} B after the disconnect; device cache entries of the "
        f"temp table {step['cache_entries_of_temp']}; information_schema tables, "
        f"columns, statistics, processlist and statements_summary equal in process and "
        f"over the wire")

    # -- 6. DROP DATABASE ----------------------------------------------------
    step, t0 = new_step(), time.perf_counter()
    dropped = []
    for tn in cat.tables(db):
        t = cat.table(db, tn)
        dropped.extend([t, getattr(t, "_base", t)])
    s.execute(f"create table fk_child (k bigint, foreign key (k) "
              f"references {db}.orders_like(o_orderkey))")
    expect_refusal(s, f"drop database {db}", "referenced by a foreign key")
    s.execute("drop table fk_child")
    v0 = cat.schema_version
    rec = timed(step, s, mods, f"drop database {db}", "drop database")
    if db in cat.databases or cat.schema_version != v0 + 1:
        raise AssertionError("storage drop: the database is still there")
    if any(e["table"] is t for e in pl.DEVICE_CACHE._entries.values() for t in dropped):
        raise AssertionError("storage drop: DEVICE_CACHE holds a dropped table")
    del dropped
    torch.cuda.synchronize()
    step["memory_allocated_after"] = torch.cuda.memory_allocated()
    rep["steps"]["drop_database"] = storage_step(
        "drop_database", t0, step,
        f"; refused while an FK pointed in, dropped in {rec['s']:.3f} s once it was gone; "
        f"no device cache entry of its tables; memory_allocated "
        f"{step['memory_allocated_after']} B")

    rep["launches"] = {}
    for st_ in rep["steps"].values():
        for k, v in st_["launches"].items():
            rep["launches"][k] = rep["launches"].get(k, 0) + v
    if not (rep["launches"].get("segagg") and rep["launches"].get("probe_count")):
        raise AssertionError(f"storage: a kernel never launched: {rep['launches']}")
    rep["s"] = time.perf_counter() - t_phase
    return rep


def _walk(plan):
    stack = [plan]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(node.children)


# -- the server phase: the MySQL protocol and the serving tier ---------------

POINT_SQL = ("select o_orderkey, o_custkey, o_orderstatus, o_totalprice, o_orderdate,"
             " o_orderpriority, o_clerk, o_shippriority, o_comment from orders"
             " where o_orderkey = ?")
# the point-select fleet: connections, and statements from each (2,000
# each before the mesh phase took its share of the script's time limit)
CONCURRENT_QUERIES = ("q1", "q3")  # each of the server phase's 4 analysts runs them
POINT_CONNS, POINT_STMTS = 16, 50  # 1,000 before the DCN phase, 500 before the graphs step, 100 before SF10 (the time limit)
# the text rows of the five queries as the port's Session types them
WIRE_TYPES = {"q1": (str, str, str, str, str, str, float, float, float, int),
              "q6": (str,), "q3": (int, str, str, int), "q5": (str, str),
              "q18": (str, int, int, str, str, str)}


def _typed(q, rows):
    return [tuple(None if v is None else f(v) for f, v in zip(WIRE_TYPES[q], r))
            for r in rows]


def numpy_orders(np, o, keys):
    """Each key's orders row as the binary protocol returns it (None:
    absent)."""
    n = o.n
    okey = o.data["o_orderkey"][:n]
    pos = _lookup(np, okey, int(okey.max()))
    live = o.live_mask(0, n)
    out = {}
    for k in keys:
        r = int(pos[k]) if 0 <= k < len(pos) else -1
        if r < 0 or not live[r]:
            out[k] = None
            continue
        v = {c: o.data[c][r] for c in o.data}
        dec = lambda c: o.dicts[c].values[int(v[c])]  # noqa: E731
        tp = int(v["o_totalprice"])
        out[k] = (int(v["o_orderkey"]), int(v["o_custkey"]), dec("o_orderstatus"),
                  f"{tp // 100}.{tp % 100:02d}", _iso(np, v["o_orderdate"]),
                  dec("o_orderpriority"), dec("o_clerk"), int(v["o_shippriority"]),
                  dec("o_comment"))
    return out


def _summary_entry(cat, sql):
    from tidb_tpu_torch.bindinfo import normalize_sql, sql_digest

    digest = sql_digest(normalize_sql(sql))
    return next((e for e in cat.stmt_summary.top(10_000) if e["digest"] == digest),
                {"exec_count": 0, "dispatches": 0, "xfer_bytes": 0})


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else 0.0


def point_fleet(np, cat, port: int, n_conns: int, n_stmts: int) -> dict:
    """Prepared point-selects on `orders` (a tenth of the keys absent)
    from `n_conns` connections of `n_stmts` each against the server on
    `port`. The clients run in a process of their own, as a client fleet
    would: client threads in this one would take the GIL from the server
    they measure. Every row must equal numpy's. Returns the statement and
    absent counts, the fleet's wall time, the per-statement latencies and
    the client process's time."""
    o = cat.table("test", "orders")
    okeys = o.data["o_orderkey"][:o.n]
    rng = np.random.default_rng(7)
    n_all = n_conns * n_stmts
    keys = rng.choice(okeys, n_all)
    absent = rng.random(n_all) < 0.1
    # an absent key: past the largest one
    gap = int(okeys.max()) + 1 + rng.integers(0, 1 << 20, n_all)
    keys = np.where(absent, gap, keys).astype(np.int64)
    want = numpy_orders(np, o, set(int(k) for k in keys))
    keys_path = os.path.join(OUT_DIR, "point_keys.json")
    out_path = os.path.join(OUT_DIR, "point_rows.json")
    with open(keys_path, "w") as f:
        json.dump([int(k) for k in keys], f)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.point_clients(*sys.argv[1:]))",
         str(port), str(n_conns), keys_path, out_path],
        cwd=here, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"point-select clients failed: {r.stderr[-2000:]}")
    with open(out_path) as f:
        got = json.load(f)
    os.remove(out_path)
    os.remove(keys_path)
    for k, rows in zip(keys, got["rows"]):
        w = want[int(k)]
        if [tuple(x) for x in rows] != ([] if w is None else [w]):
            raise AssertionError(f"point-select {k}: {rows} vs numpy {w}")
    return {"statements": n_all, "absent": int(absent.sum()), "wall_s": got["wall_s"],
            "latency_s": got["latency_s"], "client_process_s": time.perf_counter() - t0}


def point_clients(port, n_conns, keys_path, out_path) -> int:
    """The point-select client fleet, run in its own process by
    point_fleet: `n_conns` connections, each preparing POINT_SQL and
    executing its share of the keys in `keys_path` (connection i takes
    every n_conns-th key from i), all started together. Writes the rows
    in key order, the per-statement latencies and the wall time to
    `out_path`."""
    import threading

    from tidb_tpu_torch.server.client import Client

    port, n_conns = int(port), int(n_conns)
    with open(keys_path) as f:
        keys = json.load(f)
    clients = [Client(port=int(port), timeout=600) for _ in range(n_conns)]
    sids = [c.prepare(POINT_SQL)[0] for c in clients]
    clients[0].execute_prepared(sids[0], [keys[0]])  # the plan-cache fill
    rows = [None] * len(keys)
    lat = [[] for _ in range(n_conns)]
    errs = []
    barrier = threading.Barrier(n_conns)

    def run(ci):
        try:
            barrier.wait(60)
            for j in range(ci, len(keys), n_conns):
                t1 = time.perf_counter()
                rows[j] = clients[ci].execute_prepared(sids[ci], [keys[j]])[1]
                lat[ci].append(time.perf_counter() - t1)
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(repr(e))

    ts = [threading.Thread(target=run, args=(ci,)) for ci in range(n_conns)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(900)
    wall = time.perf_counter() - t0
    for c in clients:
        c.close()
    if errs or any(t.is_alive() for t in ts):
        print(f"point clients failed: {errs[:3]}", file=sys.stderr)
        return 1
    with open(out_path, "w") as f:
        json.dump({"rows": rows, "wall_s": wall,
                   "latency_s": [x for xs in lat for x in xs]}, f)
    return 0


def phase_server(torch, np, s, mods, warm_s) -> dict:
    """The port's MySQL-protocol server over the SF1 catalog of `s`
    (phase_server in the module docstring). Every step fails the run on
    a wrong answer; returns the report."""
    from tidb_tpu_torch.storage.tpch_queries import Q

    cat = s.catalog
    rep = {"card": card_line()}
    t_phase = time.perf_counter()
    # the phase holds each wire statement's launches to a solo run's, so it
    # needs a fixed plan: it pins the eager-aggregation push-down with the
    # sysvar (a user's tidb_opt_agg_push_down = 0 is never overridden by
    # plan feedback's measured push-down decision, which would otherwise
    # alternate Q18's plans while it explores), and runs each query until
    # two runs in a row take the same plan, so the feedback store's join
    # hints have settled before the compared runs
    s.execute("set global tidb_opt_agg_push_down = 0")
    rep["pinned"] = {"tidb_opt_agg_push_down": 0, "settle_runs": {}}
    try:
        for q in REFRESH_QUERIES:
            rep["pinned"]["settle_runs"][q] = settle_plan(s, Q[q][0])
        log(f"server: plan pinned by tidb_opt_agg_push_down = 0; runs until the plan "
            f"settled: {rep['pinned']['settle_runs']}")
        return _phase_server(torch, np, s, mods, warm_s, rep, t_phase)
    finally:
        s.execute("set global tidb_opt_agg_push_down = 1")


def settle_plan(s, sql: str, most: int = 5) -> int:
    """Run `sql` until two runs in a row take the same plan (plan feedback
    reshapes a plan from the cardinalities its runs record); returns the
    runs it took."""
    last = None
    for n in range(1, most + 1):
        s.query(sql)
        if s._last_plan_digest == last:
            return n
        last = s._last_plan_digest
    raise AssertionError(f"the plan of {sql[:60]!r} did not settle in {most} runs")


def _phase_server(torch, np, s, mods, warm_s, rep, t_phase) -> dict:
    import signal
    import threading
    import urllib.request

    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.server.client import Client, ServerError
    from tidb_tpu_torch.storage.tpch_queries import Q
    from tidb_tpu_torch.utils import dispatch, jitcache
    from tidb_tpu_torch.utils import metrics as M

    seg_mod, hp, jk, pl, st, agg_mod = mods
    cat = s.catalog
    t0 = time.perf_counter()
    srv = Server(catalog=cat, host="127.0.0.1", port=0, status_port=0, device="cuda")
    srv.start()
    rep["start_s"] = time.perf_counter() - t0
    log(f"server: started on {srv.device} port {srv.port} status {srv.status_port} "
        f"in {rep['start_s']:.3f} s")
    seg_mod.reset_launches()
    hp.reset_launches()
    conns = []

    def connect():
        c = Client(port=srv.port, timeout=600)
        conns.append(c)
        return c

    try:
        # -- the five queries over one connection --------------------------
        c = connect()
        res, five = {}, {}
        for q in REFRESH_QUERIES:
            sql = Q[q][0]
            d0 = dispatch.count()
            solo_rows = s.query(sql)  # in process: its own launches
            solo = dispatch.count() - d0
            e0 = _summary_entry(cat, sql)
            t0 = time.perf_counter()
            names, rows = c.query(sql)
            wall = time.perf_counter() - t0
            e1 = _summary_entry(cat, sql)
            res[q] = _typed(q, rows)
            if res[q] != solo_rows:
                raise AssertionError(f"server {q}: wire rows differ from the session's")
            wire_launches = e1["dispatches"] - e0["dispatches"]
            if e1["exec_count"] - e0["exec_count"] != 1 or wire_launches != solo:
                raise AssertionError(f"server {q}: {wire_launches} launches over the "
                                     f"wire, {solo} solo")
            five[q] = {"wire_s": wall, "in_process_median_s": warm_s.get(q),
                       "launches": wire_launches, "solo_launches": solo,
                       "xfer_bytes": e1["xfer_bytes"] - e0["xfer_bytes"]}
            log(f"server {q}: {wall * 1e3:.3f} ms over the wire against "
                f"{(warm_s.get(q) or 0) * 1e3:.3f} ms in process (phase 3 median); "
                f"launches {wire_launches} (solo {solo})")
        check_five(np, res, cat, "server")
        rep["five"] = five

        # -- prepared point-selects from 16 connections --------------------
        c0 = M.BATCH_COALESCE_TOTAL.value()
        b0 = M.BATCH_SIZE.count()
        hist0 = {k: list(v) for k, v in M.BATCH_SIZE._counts.items()}
        fleet = point_fleet(np, cat, srv.port, POINT_CONNS, POINT_STMTS)
        n_all, absent, wall = fleet["statements"], fleet["absent"], fleet["wall_s"]
        batches = M.BATCH_SIZE.count() - b0
        flat = fleet["latency_s"]
        sizes = {}
        for key, counts in M.BATCH_SIZE._counts.items():
            before = hist0.get(key, [0] * len(counts))
            for bound, n1, n0 in zip(list(M.BATCH_SIZE.buckets) + ["inf"], counts, before):
                if n1 - n0:
                    sizes[str(bound)] = sizes.get(str(bound), 0) + n1 - n0
        coalesced = M.BATCH_COALESCE_TOTAL.value() - c0
        multi = sum(v for k, v in sizes.items() if k != "1")
        rep["point_select"] = {
            "connections": POINT_CONNS, "statements": n_all,
            "absent": absent, "wall_s": wall, "stmts_per_s": n_all / wall,
            "p50_ms": _pct(flat, 0.50) * 1e3, "p99_ms": _pct(flat, 0.99) * 1e3,
            "batches": batches, "coalesced_stmts": coalesced,
            "batch_size_histogram": sizes,
            "mean_batch_size": (n_all / batches) if batches else 0.0,
            "client_process_s": fleet["client_process_s"]}
        if not multi or coalesced < 2:
            raise AssertionError(f"no batch had more than one member: {sizes}")
        log(f"server point-selects: {n_all} ({absent} absent) from "
            f"{POINT_CONNS} connections in {wall:.3f} s = {n_all / wall:.1f} stmt/s, "
            f"p50 {rep['point_select']['p50_ms']:.3f} ms p99 "
            f"{rep['point_select']['p99_ms']:.3f} ms; {batches} batches, mean size "
            f"{rep['point_select']['mean_batch_size']:.3f}, histogram {sizes}; "
            f"{coalesced:.0f} statements rode a batch of two or more")

        # -- concurrent analytics: 4 connections, Q1 and Q3 each (Q18 too
        # until the SF10 phase took its share of the time limit) -----------
        solo = {}
        for q in CONCURRENT_QUERIES:
            d0 = dispatch.count()
            s.query(Q[q][0])
            solo[q] = dispatch.count() - d0
        cat.global_vars["tidb_slow_log_threshold"] = 0  # a slow-log row each
        # the log keeps its last 128 rows: mark where this step's begin
        cat.slow_queries.clear()
        acl = [connect() for _ in range(4)]
        orders_ = [CONCURRENT_QUERIES, CONCURRENT_QUERIES[::-1]] * 2
        got, errs = {}, []

        def analyst(i):
            try:
                for q in orders_[i]:
                    got[(i, q)] = _typed(q, acl[i].query(Q[q][0])[1])
            except BaseException as e:  # noqa: BLE001 — raised below
                errs.append(e)

        ts = [threading.Thread(target=analyst, args=(i,)) for i in range(4)]
        jitcache.reset_runs()
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join(600)
        cwall = time.perf_counter() - t0
        cat.global_vars["tidb_slow_log_threshold"] = 300
        if errs or any(t.is_alive() for t in ts):
            raise AssertionError(f"concurrent analytics failed: {errs[:3]}")
        # the connections' fused batches replayed CUDA graphs while the
        # other connections ran theirs
        rep["concurrent_programs"] = jitcache.runs()
        if not sum(r.get("replay", 0) for r in rep["concurrent_programs"].values()):
            raise AssertionError(f"the concurrent connections replayed no graph: "
                                 f"{rep['concurrent_programs']}")
        log(f"server concurrent analytics: cached programs by how they ran "
            f"{rep['concurrent_programs']}")
        for (i, q), rows in got.items():
            if rows != res[q]:
                raise AssertionError(f"concurrent {q} on connection {i} differs")
        rows_slow = list(cat.slow_queries)
        per_stmt = {}
        for q in CONCURRENT_QUERIES:
            text = Q[q][0].strip()[:2048]
            ds = [r[7] for r in rows_slow if r[3] == text]
            per_stmt[q] = ds
            if len(ds) != 4 or any(d != solo[q] for d in ds):
                raise AssertionError(f"concurrent {q}: launches {ds}, solo {solo[q]}")
        rep["concurrent"] = {"wall_s": cwall, "launches": per_stmt, "solo": solo}
        log(f"server concurrent analytics: {4 * len(CONCURRENT_QUERIES)} statements on 4 connections in "
            f"{cwall:.3f} s; launches per statement {per_stmt} (solo {solo})")

        # -- KILL and the statement deadline -------------------------------
        victim, killer = connect(), connect()
        cid = int(victim.query("select connection_id()")[1][0][0])
        before = {k: (id(e["chunks"]), e["nbytes"]) for k, e in pl.DEVICE_CACHE._entries.items()}
        box = {}

        def run_victim():
            try:
                box["rows"] = victim.query(Q["q18"][0])
            except ServerError as e:
                box["err"] = (e.code, e.message)
            box["t"] = time.perf_counter()

        th = threading.Thread(target=run_victim)
        th.start()
        time.sleep(0.2)
        tk = time.perf_counter()
        killer.execute(f"kill query {cid}")
        th.join(600)
        if box.get("err", (None,))[0] != 1317:
            raise AssertionError(f"KILL QUERY: {box}")
        kill_latency = box["t"] - tk
        victim.execute("set session max_execution_time = 50")
        t0 = time.perf_counter()
        try:
            victim.query(Q["q18"][0])
            raise AssertionError("Q18 under max_execution_time = 50 completed")
        except ServerError as e:
            if e.code != 3024:
                raise
            deadline_s = time.perf_counter() - t0
        victim.execute("set session max_execution_time = 0")
        after = {k: (id(e["chunks"]), e["nbytes"]) for k, e in pl.DEVICE_CACHE._entries.items()}
        if any(before.get(k) != v for k, v in after.items()):
            raise AssertionError("a statement cut short put a staging into the cache")
        for e in pl.DEVICE_CACHE._entries.values():
            if pl._pytree_nbytes(e["chunks"]) != e["nbytes"]:
                raise AssertionError("a device buffer cache entry is not whole")
        for cl in (victim, killer):
            for q in ("q1", "q18"):
                if _typed(q, cl.query(Q[q][0])[1]) != res[q]:
                    raise AssertionError(f"{q} after KILL differs")
        alive = [t.name for t in threading.enumerate()
                 if t.name == "tidb-torch-prefetch" and t.is_alive()]
        if alive:
            raise AssertionError(f"prefetch threads alive after KILL: {alive}")
        rep["kill"] = {"kill_latency_s": kill_latency, "deadline_error_s": deadline_s}
        log(f"server KILL QUERY 0.2 s into Q18: 1317 after {kill_latency * 1e3:.3f} ms; "
            f"max_execution_time = 50: 3024 after {deadline_s * 1e3:.3f} ms; Q1 and Q18 "
            f"right afterwards on both connections; no prefetch thread alive")

        # -- the status port ------------------------------------------------
        base = f"http://127.0.0.1:{srv.status_port}"
        st_body = json.loads(urllib.request.urlopen(base + "/status", timeout=30).read())
        metrics = urllib.request.urlopen(base + "/metrics", timeout=30).read().decode()
        for fam in ("tidb_tpu_plan_cache_total{", "tidb_tpu_device_cache_total{",
                    "tidb_tpu_batch_size_bucket{", "tidb_tpu_device_dispatch_total{"):
            if fam not in metrics:
                raise AssertionError(f"/metrics lacks {fam}")
        rep["status"] = st_body
        log(f"server status port: /status {st_body}; /metrics "
            f"{len(metrics.splitlines())} lines with the plan-cache, device-cache, "
            "batch-size and launch families")
    finally:
        for cl in conns:
            try:
                cl.close()
            except OSError:
                pass
        t0 = time.perf_counter()
        srv.shutdown(drain=True)
        rep["shutdown_s"] = time.perf_counter() - t0
    left = [t.name for t in threading.enumerate()
            if t.is_alive() and t.name.startswith(("sched-worker", "ddl-worker",
                                                    "server-accept", "status-http"))]
    if left:
        raise AssertionError(f"threads alive after shutdown: {left}")
    rep["launches"] = {**seg_mod.LAUNCHES, **hp.LAUNCHES}
    log(f"server shutdown(drain=True) in {rep['shutdown_s']:.3f} s, no scheduler, DDL "
        f"or accept thread left; launches in the phase {rep['launches']}")

    # -- the entry point as a subprocess --------------------------------
    cmd = [sys.executable, "-m", "tidb_tpu_torch", "--port", "0", "--status-port", "-1",
           "--load-tpch", "0.01"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        port = None
        while time.perf_counter() - t0 < 300:
            line = proc.stderr.readline()
            if not line:
                break
            if "listening on" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        if port is None:
            raise AssertionError("python -m tidb_tpu_torch reported no port")
        cl = Client(port=port, timeout=120)
        _n, rows = cl.query(Q["q6"][0])
        cl.close()
        up = time.perf_counter() - t0
        proc.send_signal(signal.SIGINT)
        code = proc.wait(timeout=60)
        if code != 0 or len(rows) != 1:
            raise AssertionError(f"python -m tidb_tpu_torch exited {code}, Q6 {rows}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    rep["entry_point"] = {"up_s": up, "total_s": time.perf_counter() - t0, "q6": rows}
    rep["s"] = time.perf_counter() - t_phase
    log(f"server entry point: python -m tidb_tpu_torch up and answering Q6 at "
        f"SF0.01 in {up:.3f} s, SIGINT exit 0; phase {rep['s']:.1f} s")
    return rep


# ---------------------------------------------------------------------------
# phase_planner: spill and memory accounting, plan feedback, the cascades
# memo, the index join and SQL bindings
# ---------------------------------------------------------------------------

# the statement budget of the spill steps. 64 MB would be below Q18's three
# hash-join builds alone at SF1 (charged to `hashjoin.build`, which cannot
# spill), in the reference as in the port (at SF0.1 both give QueryOOMError
# under 6.4 MB and spill under 20 MB and up), so the phase takes 256 MB: the
# builds fit, and lineitem grouped by order (the host generic aggregation's
# raw runs) and the sort's runs do not
SPILL_QUOTA = "256 MB"
SORT_SQL = ("select {hint}l_orderkey, l_linenumber, l_extendedprice from lineitem "
            "where l_orderkey <= {kmax} "
            "order by l_extendedprice desc, l_orderkey, l_linenumber")
# the ORDER BY sorts the lineitems of this quantile of the order keys
# under SORT_QUOTA (all of lineitem under SPILL_QUOTA, 22-27 s, before
# the SF10 phase took its share of the time limit)
SORT_SHARE = 0.5
SORT_QUOTA = "64 MB"
TILE_DUPS = 16  # build rows per key of the many-to-many join
INDEX_JOIN_DATE = "1995-03-15"
INDEX_JOIN_SQL = ("select count(*), sum(l_extendedprice) from customer join orders "
                  "on c_custkey = o_custkey join lineitem on l_orderkey = o_orderkey "
                  f"where o_orderdate = '{INDEX_JOIN_DATE}'")


@contextlib.contextmanager
def statement_trackers(s):
    """The memory trackers of the statements `s` runs inside the block (the
    session's exec contexts, spied)."""
    seen = []
    orig = s._exec_ctx

    def spy(**kw):
        ctx = orig(**kw)
        seen.append(ctx)
        return ctx

    s._exec_ctx = spy
    try:
        yield seen
    finally:
        del s._exec_ctx


def planner_step(s, mods, sql, label, step_log, check=None):
    """One statement with the kernels' counters set to 0 just before it and
    read just after, its trackers and spill bytes; raises what it raised
    after recording it. Every tracker must end at consumed 0."""
    from tidb_tpu_torch.utils import dispatch

    seg_mod, hp = mods[0], mods[1]
    seg_mod.reset_launches()
    hp.reset_launches()
    sp0 = dispatch.spill_bytes()
    rec = {"label": label}
    t0 = time.perf_counter()
    err = rows = None
    with statement_trackers(s) as ctxs:
        try:
            rows = s.query(sql)
        except Exception as e:  # noqa: BLE001 — recorded, re-raised below
            err = e
    rec["s"] = time.perf_counter() - t0
    rec["launches"] = launches_of(mods)
    rec["spill_bytes"] = dispatch.spill_bytes() - sp0
    rec["max_consumed"] = max((c.mem_tracker.max_consumed for c in ctxs), default=0)
    rec["consumed_after"] = [c.mem_tracker.consumed for c in ctxs]
    rec["join_tiles"] = [c.join_tiles for c in ctxs]
    rec["error"] = None if err is None else f"{type(err).__name__}: {err}"
    rec["rows"] = None if rows is None else len(rows)
    step_log.append(rec)
    log(f"planner {label}: {rec['s']:.3f} s; launches segagg "
        f"{rec['launches']['segagg']} probe_count {rec['launches']['probe_count']}; "
        f"spill_bytes {rec['spill_bytes']}; max_consumed {rec['max_consumed']}; "
        f"consumed after {rec['consumed_after']}"
        + (f"; {rec['error']}" if err is not None else f"; {rec['rows']} rows"))
    if any(rec["consumed_after"]):
        raise AssertionError(f"planner {label}: a tracker ends at "
                             f"{rec['consumed_after']}, not 0")
    if err is not None:
        raise err
    if check is not None:
        check(rows)
    return rows, rec


def modeled_cost(s, sql: str, cascades: bool) -> float:
    """The sum of the modeled intermediate join cardinalities of the
    optimized logical plan of `sql`: the join-order search's cost."""
    from tidb_tpu_torch.parser import parse
    from tidb_tpu_torch.planner.binder import Binder
    from tidb_tpu_torch.planner.logical import BuildContext, LJoin, build_select
    from tidb_tpu_torch.planner.physical import _estimate, eq_join_rows
    from tidb_tpu_torch.planner.rules import optimize_logical

    total = 0.0
    stack = [optimize_logical(build_select(parse(sql)[0], BuildContext(
        catalog=s.catalog, db="test", binder=Binder(),
        execute_subplan=s._execute_subplan)), cascades=cascades)]
    while stack:
        p = stack.pop()
        stack.extend(getattr(p, "children", []))
        if isinstance(p, LJoin) and p.kind in ("inner", "cross"):
            l, r = p.children
            total += float(eq_join_rows(l, r, p.eq_conds, _estimate(l), _estimate(r))
                           if p.eq_conds else _estimate(l) * _estimate(r))
    return total


def numpy_sorted_lineitem(np, li, kmax):
    """ORDER BY l_extendedprice DESC, l_orderkey, l_linenumber over the
    model's live lineitem rows with l_orderkey <= kmax: (orderkey,
    linenumber, scaled price)."""
    ok, ln, pr = (li.data[c] for c in ("l_orderkey", "l_linenumber", "l_extendedprice"))
    m = ok <= kmax
    ok, ln, pr = ok[m], ln[m], pr[m]
    order = np.lexsort((ln, ok, -pr))
    return ok[order], ln[order], pr[order]


def check_sorted(np, rows, want):
    """The sort's rows against numpy: the length, the first and last 1,000
    rows exactly, every row's (orderkey, linenumber) in order, and the
    price of every 1,009th row."""
    ok, ln, pr = want
    n = len(ok)
    if len(rows) != n:
        raise AssertionError(f"sort: {len(rows)} rows, numpy has {n}")
    for i in list(range(min(1000, n))) + list(range(max(n - 1000, 0), n)):
        g = rows[i]
        if (g[0], g[1], _scaled(g[2])) != (int(ok[i]), int(ln[i]), int(pr[i])):
            raise AssertionError(f"sort row {i}: {g} vs numpy "
                                 f"{(int(ok[i]), int(ln[i]), int(pr[i]))}")
    gok = np.fromiter((r[0] for r in rows), np.int64, n)
    gln = np.fromiter((r[1] for r in rows), np.int64, n)
    if not (np.array_equal(gok, ok) and np.array_equal(gln, ln)):
        bad = int(np.nonzero((gok != ok) | (gln != ln))[0][0])
        raise AssertionError(f"sort: row {bad} is {rows[bad]}, numpy "
                             f"({int(ok[bad])}, {int(ln[bad])})")
    for i in range(0, n, 1009):
        if _scaled(rows[i][2]) != int(pr[i]):
            raise AssertionError(f"sort row {i}: price {rows[i][2]} vs numpy {int(pr[i])}")


@contextlib.contextmanager
def plans_run(s):
    """The physical plans `s` acquires for the statements it runs inside
    the block (Session._acquire_plan, spied): the plans actually run."""
    ran = []
    orig = s._acquire_plan

    def acquire(stmt, agg_push_down=None):
        plan = orig(stmt, agg_push_down)
        ran.append(plan)
        return plan

    s._acquire_plan = acquire
    try:
        yield ran
    finally:
        del s._acquire_plan


def phase_planner(torch, np, s, mods) -> dict:
    """Spill and memory accounting, plan feedback, the cascades memo, the
    index join and SQL bindings at SF1 on the session `s` (item 8 of the
    module docstring). Every step fails the run on a wrong answer; returns
    the report."""
    import tempfile
    import urllib.request

    from tidb_tpu_torch.parser import parse
    from tidb_tpu_torch.planner import feedback as fb
    from tidb_tpu_torch.planner.physical import explain_text
    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.storage.tpch_queries import Q
    from tidb_tpu_torch.utils.memory import QueryOOMError

    seg_mod, hp, jk, pl, st, agg_mod = mods
    cat = s.catalog
    s.execute("use test")
    rep = {"card": card_line(), "steps": [], "spill_quota": SPILL_QUOTA}
    steps = rep["steps"]
    t_phase = time.perf_counter()
    model = ArrayModel(np, cat)
    li = model.table("test", "lineitem")
    q18 = Q["q18"][0]
    q18_want = numpy_q18(np, model)[0]
    hinted = f"/*+ MEMORY_QUOTA({SPILL_QUOTA}) */ "

    # -- 1. spill ---------------------------------------------------------
    spill_dir = os.path.abspath(os.path.join("build", "planner_spill"))
    os.makedirs(spill_dir, exist_ok=True)
    saved_tmp = tempfile.tempdir
    tempfile.tempdir = spill_dir
    try:
        s.execute("set tidb_device_engine_mode = 'off'")
        q18_off = q18.replace("select", "select " + hinted, 1)
        _, r_off = planner_step(
            s, mods, q18_off, "q18 engine off under quota", steps,
            check=lambda rows: check_join_rows("q18", rows, q18_want, {4, 5}))
        if r_off["spill_bytes"] <= 0:
            raise AssertionError(f"Q18 under {SPILL_QUOTA} did not spill: {r_off}")
        _, r_off_free = planner_step(
            s, mods, q18, "q18 engine off, no quota", steps,
            check=lambda rows: check_join_rows("q18", rows, q18_want, {4, 5}))
        s.execute("set tidb_device_engine_mode = 'auto'")
        lkeys = li.data["l_orderkey"]
        sort_kmax = int(np.sort(lkeys)[int(len(lkeys) * SORT_SHARE) - 1])
        want_sorted = numpy_sorted_lineitem(np, li, sort_kmax)
        sort_hint = f"/*+ MEMORY_QUOTA({SORT_QUOTA}) */ "
        _, r_sort = planner_step(s, mods, SORT_SQL.format(hint=sort_hint, kmax=sort_kmax),
                                 "order by under quota", steps,
                                 check=lambda rows: check_sorted(np, rows, want_sorted))
        if r_sort["spill_bytes"] <= 0:
            raise AssertionError(f"the ORDER BY under {SORT_QUOTA} did not spill")
        # (its run with no quota, 25 s, was cut for the DCN phase's time)
        try:
            planner_step(s, mods, q18.replace("select", "select " + hinted, 1),
                         "q18 default mode under quota", steps,
                         check=lambda rows: check_join_rows("q18", rows, q18_want, {4, 5}))
            rep["q18_default_under_quota"] = "completed"
        except QueryOOMError:
            rep["q18_default_under_quota"] = "QueryOOMError"
        s.execute("set tidb_enable_tmp_storage_on_oom = OFF")
        try:
            planner_step(s, mods, SORT_SQL.format(hint=sort_hint, kmax=sort_kmax),
                         "order by under quota, spill off", steps)
            raise AssertionError("the ORDER BY with spilling off did not raise "
                                 "QueryOOMError")
        except QueryOOMError:
            pass
        finally:
            s.execute("set tidb_enable_tmp_storage_on_oom = 1")
        left = [n for n in os.listdir(spill_dir) if n.startswith("tidb_tpu_spill_")]
        if left:
            raise AssertionError(f"spill files left behind: {left}")
    finally:
        tempfile.tempdir = saved_tmp
        s.execute("set tidb_device_engine_mode = 'auto'")
    rep["spill"] = {"q18_off_s": r_off["s"], "q18_off_free_s": r_off_free["s"],
                    "sort_s": r_sort["s"],
                    "q18_off_spill_bytes": r_off["spill_bytes"],
                    "sort_spill_bytes": r_sort["spill_bytes"]}
    log(f"planner spill: Q18 (engine off) {r_off['s']:.3f} s under {SPILL_QUOTA} "
        f"({r_off['spill_bytes']} B spilled) against {r_off_free['s']:.3f} s without; "
        f"ORDER BY {r_sort['s']:.3f} s ({r_sort['spill_bytes']} B spilled); Q18 in "
        f"the default mode under the quota: "
        f"{rep['q18_default_under_quota']}; no spill file left")

    # -- 2. plan feedback -------------------------------------------------
    # the push-down protocol measures warm runs, which come from the plan
    # cache: the step turns the text statements' plan cache on (and off
    # again), and starts from an empty feedback store
    fb.STORE.on_schema_change()
    s.execute("set tidb_enable_non_prepared_plan_cache = 1")
    digest = s._stmt_digest(parse(q18)[0], q18)[1]
    rep["feedback"] = []
    agg_chunks = count_segment_chunks()
    try:
        for i in range(4):
            before = fb.STORE.apd_decision(digest)
            agg_chunks[0] = 0
            with plans_run(s) as ran:
                rows, c, dt = run_query(s, mods, q18)
            plan = ran[-1]
            check_path(f"q18 feedback run {i + 1}", c, agg_chunks[0],
                       plan_fragments(plan, s._plan_capacity(plan)))
            check_join_rows("q18", rows, q18_want, {4, 5})
            eager = has_eager_partial(plan)
            entry = {"run": i + 1, "s": dt, "decision_before": before,
                     "agg_push_down": s._fb_last_apd, "eager_partial": eager,
                     "decision_after": fb.STORE.apd_decision(digest),
                     "from_plan_cache": bool(s.sysvars.get("last_plan_from_cache")),
                     "launches": c["launches"], "plan": explain_text(plan)}
            rep["feedback"].append(entry)
            log(f"planner feedback Q18 run {i + 1}: {dt:.3f} s; push-down decision "
                f"{before} -> plan {'with' if eager else 'without'} the eager partial "
                f"(agg_push_down {s._fb_last_apd}, plan cache "
                f"{entry['from_plan_cache']}); decision now {entry['decision_after']}; "
                f"rows equal numpy; probe_count {c['launches']['probe_count']}, segagg "
                f"{c['launches']['segagg']}")
        if not rep["feedback"][0]["eager_partial"] or rep["feedback"][1]["eager_partial"]:
            raise AssertionError("Q18's first run did not push the eager partial, or "
                                 "the second did not explore the plan without it: "
                                 f"{[e['eager_partial'] for e in rep['feedback']]}")
    finally:
        s.execute("set tidb_enable_non_prepared_plan_cache = 0")

    # information_schema.plan_feedback in process and over /plan_feedback
    srv = Server(catalog=cat, host="127.0.0.1", port=0, status_port=0, device="cuda")
    srv.start()
    try:
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.status_port}/plan_feedback?top=1000", timeout=60).read())
    finally:
        srv.shutdown(drain=True)
    rows = s.query("select digest, plan_digest, variant, execs from "
                   "information_schema.plan_feedback")
    in_process = {tuple(r) for r in rows}
    over_http = {(d["digest"], v["plan_digest"], "push" if v["agg_push_down"] else "no_push",
                  v["execs"]) for d in doc["digests"] for v in d["variants"]}
    if not in_process or in_process != over_http:
        raise AssertionError(f"plan_feedback: {sorted(in_process)[:4]} in process, "
                             f"{sorted(over_http)[:4]} over /plan_feedback")
    rep["plan_feedback_rows"] = len(rows)
    log(f"planner: information_schema.plan_feedback ({len(rows)} rows, "
        f"{len(in_process)} variants) equals /plan_feedback")

    # EXPLAIN ANALYZE of Q3: the est and drift columns
    ea = s.execute("explain analyze " + Q["q3"][0]).rows
    head = ea[0][0]
    if not all(c in head for c in ("estRows", "actRows", "drift")):
        raise AssertionError(f"EXPLAIN ANALYZE's header lacks est/drift: {head}")
    drifts = [ln[0][head.index("drift"):head.index("time")].strip() for ln in ea[1:-1]]
    if not any(re.fullmatch(r"\d+\.\d\d", d) for d in drifts):
        raise AssertionError(f"EXPLAIN ANALYZE of Q3 shows no drift: {drifts}")
    rep["q3_explain_analyze"] = [r[0] for r in ea]
    log("planner: EXPLAIN ANALYZE of Q3 with est and drift columns:\n"
        + "\n".join(r[0] for r in ea))

    # a many-to-many join whose fused probe overflows its first tile: the
    # second run's join_tiles comes from the tile hint
    s.execute("create table planner_dup (k bigint, v bigint)")
    try:
        cat.table("test", "planner_dup").insert_columns({
            "k": np.zeros(TILE_DUPS, dtype=np.int64),
            "v": np.arange(1, TILE_DUPS + 1, dtype=np.int64)})
        o = model.table("test", "orders")
        if not (o.data["o_shippriority"] == 0).all():
            raise AssertionError("o_shippriority is not 0 throughout")
        n_o = o.n
        tile_sql = ("select count(*), sum(v), sum(o_totalprice) from orders join "
                    "planner_dup on o_shippriority = k")
        want = (n_o * TILE_DUPS, n_o * TILE_DUPS * (TILE_DUPS + 1) // 2,
                int(o.data["o_totalprice"].sum()) * TILE_DUPS)
        expands = [0]
        real_expand = jk.expand_tiles

        def counted_expand(*a, **kw):
            from tidb_tpu_torch.utils import dispatch

            dispatch.on_execute(_bump, expands)  # at each replay too
            return real_expand(*a, **kw)

        jk.expand_tiles = counted_expand
        rep["tiles"] = []
        try:
            for i in range(2):
                expands[0] = 0
                pl.reset_counters()
                rows, r = planner_step(s, mods, tile_sql, f"many-to-many join run {i + 1}",
                                       steps)
                got = (rows[0][0], int(rows[0][1]), _scaled(rows[0][2]))
                if got != want:
                    raise AssertionError(f"many-to-many join {got} vs numpy {want}")
                if pl.PIPELINE_FUSED_TOTAL["probe"] != 1:
                    raise AssertionError(f"the many-to-many join did not probe fused: "
                                         f"{pl.PIPELINE_FUSED_TOTAL}")
                r["expand_calls"] = expands[0]
                rep["tiles"].append(r)
                log(f"planner many-to-many run {i + 1}: join_tiles {r['join_tiles']}, "
                    f"{expands[0]} expand calls, launches {r['launches']}; equals numpy")
        finally:
            jk.expand_tiles = real_expand
        t1, t2 = rep["tiles"]
        if not (max(t2["join_tiles"]) > max(t1["join_tiles"])
                and t2["expand_calls"] < t1["expand_calls"]):
            raise AssertionError(f"the tile hint did not raise join_tiles: "
                                 f"{t1['join_tiles']} -> {t2['join_tiles']}, expand "
                                 f"calls {t1['expand_calls']} -> {t2['expand_calls']}")
    finally:
        s.execute("drop table planner_dup")

    # -- 3. the cascades memo ---------------------------------------------
    rep["cascades"] = {}
    for q in ("q3", "q5"):
        sql = Q[q][0]
        greedy_cost = modeled_cost(s, sql, cascades=False)
        memo_cost = modeled_cost(s, sql, cascades=True)
        s.execute("set tidb_enable_cascades_planner = 1")
        try:
            plan = explain_text(planned(s, sql))
            rows, r = planner_step(s, mods, sql, f"{q} under the memo", steps)
        finally:
            s.execute("set tidb_enable_cascades_planner = 0")
        check_join_rows(q, rows, (numpy_q3 if q == "q3" else numpy_q5)(np, model), {1})
        if memo_cost > greedy_cost * 1.0001:
            raise AssertionError(f"{q}: the memo's plan costs {memo_cost}, greedy "
                                 f"{greedy_cost}")
        rep["cascades"][q] = {"memo_cost": memo_cost, "greedy_cost": greedy_cost,
                              "plan": plan, **r}
        log(f"planner cascades {q}: equals numpy; modeled cost {memo_cost:.1f} against "
            f"greedy {greedy_cost:.1f}; plan:\n{plan}")

    # -- 4. IndexJoinExec -------------------------------------------------
    d = _days(np, INDEX_JOIN_DATE)
    keys = o.data["o_orderkey"][o.data["o_orderdate"] == d]
    hit = np.isin(li.data["l_orderkey"], keys)
    ij_want = (int(hit.sum()), int(li.data["l_extendedprice"][hit].sum()))
    s.execute("set tidb_enable_cascades_planner = 1")
    try:
        ij_plan = [r[0] for r in s.query("explain " + INDEX_JOIN_SQL)]
        if not any("IndexJoin" in ln for ln in ij_plan):
            raise AssertionError("the memo did not plan IndexJoin:\n" + "\n".join(ij_plan))
        rows, r_ij = planner_step(s, mods, INDEX_JOIN_SQL, "index join", steps)
    finally:
        s.execute("set tidb_enable_cascades_planner = 0")
    rows_h, r_hash = planner_step(s, mods, INDEX_JOIN_SQL, "the same join, hashed", steps)
    for label, got in (("index join", rows), ("hash join", rows_h)):
        if (got[0][0], _scaled(got[0][1])) != ij_want:
            raise AssertionError(f"{label} {got} vs numpy {ij_want}")
    rep["index_join"] = {"orders": int(len(keys)), "plan": ij_plan, "s": r_ij["s"],
                         "hash_s": r_hash["s"], "launches": r_ij["launches"],
                         "hash_launches": r_hash["launches"]}
    log(f"planner index join over {len(keys)} orders of {INDEX_JOIN_DATE}: "
        f"{r_ij['s'] * 1e3:.3f} ms against {r_hash['s'] * 1e3:.3f} ms hashed; both "
        f"equal numpy; plan:\n" + "\n".join(ij_plan))

    # -- 5. SQL bindings --------------------------------------------------
    q3 = Q["q3"][0]
    default = explain_text(planned(s, q3))
    bound_sql = None
    for order in ("lineitem, orders, customer", "orders, lineitem, customer",
                  "customer, orders, lineitem", "orders, customer, lineitem"):
        cand = q3.replace("select", f"select /*+ LEADING({order}) */", 1)
        if plan_shape(explain_text(planned(s, cand))) != plan_shape(default):
            bound_sql = cand
            break
    if bound_sql is None:
        raise AssertionError("no LEADING order changes Q3's plan")
    want_bound = plan_shape(explain_text(planned(s, bound_sql)))
    s.execute(f"create global binding for {q3} using {bound_sql}")
    try:
        shown = "\n".join(r[0] for r in s.query("explain " + q3))
        with plans_run(s) as ran:
            rows, r_b = planner_step(s, mods, q3, "q3 under the binding", steps)
        check_join_rows("q3", rows, numpy_q3(np, model), {1})
        if not (plan_shape(shown) == plan_shape(explain_text(ran[-1])) == want_bound
                != plan_shape(default)):
            raise AssertionError(f"the binding did not give Q3 the hinted plan:\n{shown}")
    finally:
        s.execute(f"drop global binding for {q3}")
    after = "\n".join(r[0] for r in s.query("explain " + q3))
    if plan_shape(after) != plan_shape(default):
        raise AssertionError(f"DROP BINDING did not restore Q3's plan:\n{after}")
    rows, r_u = planner_step(s, mods, q3, "q3 after DROP BINDING", steps)
    check_join_rows("q3", rows, numpy_q3(np, model), {1})
    rep["binding"] = {"hint": bound_sql.split("*/")[0].strip() + " */", "default": default,
                      "bound": shown, "s": r_b["s"], "launches": r_b["launches"]}
    log(f"planner binding: {rep['binding']['hint']} changes Q3's plan and not its rows "
        f"({r_b['s']:.3f} s); DROP restores it. Bound plan:\n{shown}")

    launches = {}
    for r in steps:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for e in rep["feedback"]:
        for k, v in e["launches"].items():
            launches[k] = launches.get(k, 0) + v
    rep["launches"] = launches
    if not launches.get("segagg") or not launches.get("probe_count"):
        raise AssertionError(f"the planner phase missed a kernel of its path: {launches}")
    if launches.get("hash_probe") or launches.get("segsum_count") \
            or launches.get("segsum_i64"):
        raise AssertionError(f"the planner phase launched an off-path entry: {launches}")
    rep["s"] = time.perf_counter() - t_phase
    return rep


# ---------------------------------------------------------------------------
# the mesh tier: Session(mesh=...) on one card, streamed, four shards, wire
# ---------------------------------------------------------------------------

MESH_SHARDS = 4  # shards of the mesh laid over the one card
# the mesh server's point-select fleet (POINT_CONNS connections of this
# many statements each) and the connections that each stage their own
# sharding of lineitem
MESH_POINT_STMTS, MESH_MEM_CONNS = 25, 4


def mesh_executor_names() -> set:
    """The class names of the executors that run on the mesh."""
    from tidb_tpu_torch.parallel.executor import DIST_EXECUTORS

    return {cls.__name__ for cls in DIST_EXECUTORS}


def mesh_classes(s, sql: str) -> list:
    """The executor classes (depth-first) of the tree the mesh session
    builds for `sql`, planned as its next run plans it, with _run_select's
    eager-aggregation re-plan."""
    from tidb_tpu_torch.parser import parse
    from tidb_tpu_torch.session.session import _dist_engaged, _has_eager_partial

    phys = planned(s, sql)
    root = s._build_root(phys)
    if s._dist_expected() and _has_eager_partial(phys) and not _dist_engaged(root):
        root = s._build_root(s._plan_select(parse(sql)[0], agg_push_down=False))
    out, stack = [], [root]
    while stack:
        e = stack.pop()
        out.append(type(e).__name__)
        stack.extend(e.children)
    return out


def mesh_launches_add(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


# the mesh's programs (utils/jitcache.py namespaces, parallel/executor.py)
MESH_NS = ("distagg", "distjoinagg", "fragment", "aggcombine")
MESH_GRAPH_MAX_RUNS = 6  # graph runs until one plan's third (plan feedback may move it)
# the four-shard grid queries run a second time (their programs' captures):
# a semi join, an outer join with a count, an anti join with an EXISTS,
# and a scalar subquery's broadcast (all 22, 16 s, until the time limit)
MESH_GRID_RECHECK = ("q4", "q13", "q21", "q22")
# at most this many rounds of Q1, Q5 and Q18 in turn on the one-card mesh
# (mesh_mix): the first warm up and capture what the five queries' pools
# pushed out, and plan feedback may still move a plan
MESH_MIX_ROUNDS = 12


def _mesh_progs(programs: dict) -> dict:
    return {ns: r for ns, r in programs.items() if ns in MESH_NS}


def mesh_graph_runs(s, mods, sql: str, label: str, rows) -> dict:
    """Graph runs of `sql` on the mesh session `s` from an eager state
    (utils/jitcache.py's warm-ups first), until one plan runs a third time
    (plan feedback may move the plan between runs): its first warm run
    at the latest (a streamed statement's first run, whose second batch
    captures) must capture a mesh program and its second warm run capture
    nothing, every program a replay. Then one run of the same plan on the
    eager path (jitcache.eager(): the plan's capacities and probe routes
    are settled by then, as the replays'): its kernel launches and
    device_get round trips must equal the second warm run's. Every run's
    rows must equal `rows`, and the graphs must hold at most the cache's
    bound. Returns the runs' counts, the eager run's and the graphs'
    bytes."""
    from tidb_tpu_torch.planner.physical import explain_text
    from tidb_tpu_torch.utils import jitcache

    runs, seen, by_plan, last = [], {}, {}, None
    for i in range(MESH_GRAPH_MAX_RUNS):
        text = explain_text(planned(s, sql))
        got, cnt, dt = run_query(s, mods, sql)
        if got != rows:
            raise AssertionError(f"{label} graph run {i + 1}: rows differ from the eager run's")
        before = seen.get(text, 0)
        seen[text] = before + 1
        runs.append({"s": dt, "plan_runs_before": before,
                     **{k: cnt[k] for k in ("programs", "launches", "device_get")}})
        by_plan.setdefault(text, []).append(runs[-1])
        if before >= 2:
            last = runs[-1]
            break
    if last is None:
        raise AssertionError(f"{label}: no plan ran a third time in {MESH_GRAPH_MAX_RUNS} runs")
    first_two = by_plan[text][:2]
    if not any(r.get("capture") for run in first_two
               for r in _mesh_progs(run["programs"]).values()):
        raise AssertionError(f"{label}: the plan's first runs captured no mesh program: "
                             f"{[run['programs'] for run in first_two]}")
    if not _mesh_progs(last["programs"]) or any(
            set(r) != {"replay"} for r in last["programs"].values()):
        raise AssertionError(f"{label}: the second warm run's programs ran "
                             f"{last['programs']}, not all by replay")
    units = jitcache.held_units()
    with jitcache.eager():
        same = explain_text(planned(s, sql)) == text
        again, eager, eager_s = run_query(s, mods, sql)
    if again != rows:
        raise AssertionError(f"{label}: the eager run's rows differ")
    if any(set(r) != {"eager"} for r in eager["programs"].values()):
        raise AssertionError(f"{label}: the eager switch ran a graph: {eager['programs']}")
    if same:
        for k in ("launches", "device_get"):
            if last[k] != eager[k]:
                raise AssertionError(f"{label}: {k} {last[k]} by replay, {eager[k]} eagerly "
                                     f"(replayed {last['programs']}, eager {eager['programs']})")
    else:
        log(f"note: {label}: plan feedback moved the plan after the replays; the "
            f"replayed run's counts are its own plan's")
    if sum(units) > jitcache.max_bytes():
        raise AssertionError(f"{label}: the graphs hold {units} B past the quota "
                             f"{jitcache.max_bytes()}")
    return {"runs": runs, "same_plan": same, "replay_s": last["s"], "eager_s": eager_s,
            "eager": {k: eager[k] for k in ("programs", "launches", "device_get")},
            "graph_bytes": {ns: sum(v) for ns, v in jitcache.graph_bytes().items()},
            "graph_units_bytes": units, "graph_resident_bytes": sum(units)}


def mesh_five(np, s, mods, model, single_rows, label, rep) -> dict:
    """The five queries on the mesh session `s`: each against numpy over the
    tables' live rows and the single-card session's rows (exactly), its
    executor classes, its launches (tidb_segagg on Q1 and Q6, tidb_probe_count
    on every query whose tree joins on the mesh, the off-path entries
    never), one cold run on the eager path and the graph runs
    (mesh_graph_runs: the warm time of each path is its run there).
    Returns the rows."""
    from tidb_tpu_torch.storage.tpch_queries import Q
    from tidb_tpu_torch.utils import jitcache

    res, per = {}, {}
    for q in REFRESH_QUERIES:
        sql = Q[q][0]
        classes = mesh_classes(s, sql)
        with jitcache.eager():
            rows, c, cold = run_query(s, mods, sql)
            lc = c["launches"]
            mesh_launches_add(rep["launches"], lc)
            if lc["segsum_count"] or lc["segsum_i64"] or lc["hash_probe"]:
                raise AssertionError(f"{label} {q} launched an off-path kernel entry: {lc}")
            dist = [k for k in classes if k in mesh_executor_names()]
            if q in ("q1", "q6") and (not lc["segagg"] or "DistAggExec" not in dist):
                raise AssertionError(f"{label} {q}: segagg {lc['segagg']} under {classes}")
            joins = "DistJoinAggExec" in dist or "DistFragmentExec" in dist
            if q in ("q3", "q5", "q18") and (not joins or not lc["probe_count"]):
                raise AssertionError(f"{label} {q}: probe_count {lc['probe_count']} under "
                                     f"{classes}")
            if rows != single_rows[q]:
                raise AssertionError(f"{label} {q}: rows differ from the single-card session's")
        graphs = mesh_graph_runs(s, mods, sql, f"{label} {q}", rows)
        eager = graphs["eager"]
        for r in graphs["runs"] + [eager]:
            mesh_launches_add(rep["launches"], r["launches"])
        mesh_launches_add(rep["launches_replayed"], graphs["runs"][-1]["launches"])
        res[q] = rows
        per[q] = {"classes": classes, "cold_s": cold, "launches": lc, "graphs": graphs}
        log(f"{label} {q}: {len(rows)} rows equal numpy and the single-card session, "
            f"eagerly and by replay; cold {cold * 1e3:.3f} ms; warm eager "
            f"{graphs['eager_s'] * 1e3:.3f} ms, replay {graphs['replay_s'] * 1e3:.3f} "
            f"ms; graph runs {[r['programs'] for r in graphs['runs']]}; replayed launches "
            f"{ {k: v for k, v in graphs['runs'][-1]['launches'].items() if v} }, device_get "
            f"{graphs['runs'][-1]['device_get']} (eager {eager['device_get']}); graph bytes "
            f"{graphs['graph_bytes']} ({graphs['graph_resident_bytes']} B held); executors "
            f"{classes}")
    check_five(np, res, model, label)
    return {"rows": res, "per_query": per}


def mesh_mix(s, mods, rows, rep) -> dict:
    """Rounds of Q1, Q5 and Q18 in turn on the one-card mesh session `s`,
    with graphs on, as a client mixing them sends them (at most
    MESH_MIX_ROUNDS): every run's rows equal the mesh's eager rows and
    the graphs held stay within the quota after every run. Plan feedback
    may still move a plan (Q18's push-down variants are explored run by
    run), and a new plan warms up and captures programs of its own. The
    first round whose three plans are those of the two rounds before it,
    after a round with no program warming up, decides: where the three
    statements' memory pools (each the most recent unit after its run in
    the round before) fit the quota together, every program of that
    round must replay (the cache pushed none of them out, and no
    signature changed under a settled plan); where they do not, the cache
    had to evict, and its captures are printed."""
    from tidb_tpu_torch.planner.physical import explain_text
    from tidb_tpu_torch.storage.tpch_queries import Q
    from tidb_tpu_torch.utils import jitcache

    runs, plans, verdict = [], [], "no round decided (plans moving or programs warming up)"
    for r in range(MESH_MIX_ROUNDS):
        texts = {}
        for q in ("q1", "q5", "q18"):
            texts[q] = explain_text(planned(s, Q[q][0]))
            got, c, dt = run_query(s, mods, Q[q][0])
            mesh_launches_add(rep["launches"], c["launches"])
            if got != rows[q]:
                raise AssertionError(f"mesh mix round {r + 1} {q}: rows differ")
            units = jitcache.held_units()
            if sum(units) > jitcache.max_bytes():
                raise AssertionError(f"mesh mix {q}: the graphs hold {units} B past the "
                                     f"quota {jitcache.max_bytes()}")
            runs.append({"round": r + 1, "q": q, "s": dt, "pool": units[-1] if units else 0,
                         "programs": _mesh_progs(c["programs"]), "units": units})
        plans.append(texts)
        if r < 2 or not plans[-1] == plans[-2] == plans[-3] or any(
                "eager" in v for run in runs[-6:-3] for v in run["programs"].values()):
            continue  # a plan moved, or a program was still warming up
        pools = {run["q"]: run["pool"] for run in runs[-6:-3]}
        fits = sum(pools.values()) <= jitcache.max_bytes()
        replayed = all(set(v) == {"replay"} for run in runs[-3:]
                       for v in run["programs"].values())
        if fits and not replayed:
            raise AssertionError(f"mesh mix round {r + 1}: settled plans whose pools {pools} "
                                 f"fit the quota did not all replay: "
                                 f"{[run['programs'] for run in runs[-3:]]}")
        verdict = (f"round {r + 1}: pools {pools} B "
                   f"{'within' if fits else 'together over'} the quota, "
                   f"{'every program replayed' if replayed else 'captures after evictions'}")
        break
    log(f"mesh mix on {s.mesh!r}: {verdict} (quota {jitcache.max_bytes()}): "
        f"{[(run['round'], run['q'], run['programs'], round(run['s'] * 1e3, 3)) for run in runs]}")
    return {"runs": runs, "verdict": verdict}


def record_largest_segagg() -> dict:
    """Wrap tidb_tpu_torch.ops.segment_accumulate: rec["args"] keeps the
    arguments (seg, G, sel, accs) of the call over the most rows (then the
    most accumulators). rec["restore"]() puts the real function back."""
    from tidb_tpu_torch import ops

    real = ops.segment_accumulate
    rec = {"args": None, "size": (-1, -1)}

    def recording(seg, G, sel, accs):
        from tidb_tpu_torch.utils import dispatch

        size = (seg.shape[0], len(accs))
        if size > rec["size"] and not dispatch.capturing():
            rec["size"], rec["args"] = size, (seg, G, sel, list(accs))
        return real(seg, G, sel, accs)

    def restore():
        ops.segment_accumulate = real

    ops.segment_accumulate = recording
    rec["restore"] = restore
    return rec


def largest_probe_args(rec, route: str, mode: str):
    """The recorded (args, kw) of the `route`/`mode` probe_count call over
    the most probe rows (then the largest build); None if none was made."""
    keys = [k for k in rec["args"] if k[1:3] == (route, mode)]
    if not keys:
        return None
    size = lambda k: (rec["args"][k][0][0].shape[0], rec["args"][k][0][5].shape[0])  # noqa: E731
    return rec["args"][max(keys, key=size)]


def phase_mesh(torch, np, s, mods, grid_cat, grid_oracle) -> tuple:
    """The mesh tier (item 9 of the module docstring) on the SF1 catalog
    of the session `s` and the grid's SF0.1 catalog and sqlite oracle.
    Every step fails the run on a wrong answer. Returns (the report, whose
    "probe_modes" count the mesh runs' probe_count calls alone, and the
    mesh's kernel shapes: per "route/mode" the largest probe_count call's
    (args, kw), and under "segagg" the largest tidb_segagg call's
    arguments), the shapes that mesh_kernel_rows checks and times."""
    from tidb_tpu_torch.parallel import executor as pex
    from tidb_tpu_torch.storage.tpch_queries import Q

    t_phase = time.perf_counter()
    cat = s.catalog.base
    s.execute("use test")
    pex.reset_fallbacks()
    rep = {"card": card_line(), "launches": {}, "launches_replayed": {}, "grid": {}}
    model = ArrayModel(np, cat)

    # the single-card session's rows and warm medians, the yardstick
    single_rows, single = {}, {}
    for q in REFRESH_QUERIES:
        single_rows[q] = s.query(Q[q][0])
        warm = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            s.query(Q[q][0])
            warm.append(time.perf_counter() - t0)
        single[q] = {"warm_s": warm, "warm_median_s": statistics.median(warm)}
    rep["single_card"] = single
    # the mesh runs alone are recorded: probe_count by route and mode, and
    # the largest call of each kernel for mesh_kernel_rows
    hp = mods[1]
    probes = record_probe_chunks(hp, args=True)
    segs = record_largest_segagg()
    try:
        mesh_steps(torch, np, cat, mods, model, single_rows, grid_cat, grid_oracle, rep)
    finally:
        stop_recording(probes)
        segs["restore"]()
    modes = recorded_modes(probes)
    rep["probe_modes"] = modes
    shapes = {m: largest_probe_args(probes, *m.split("/")) for m in modes}
    shapes["segagg"] = segs["args"]
    rep["s"] = time.perf_counter() - t_phase
    log(f"mesh phase passed in {rep['s']:.1f} s; fallbacks to one device "
        f"{rep['fallbacks']}; launches {rep['launches']} (the five queries' replayed "
        f"second warm runs on both meshes: {rep['launches_replayed']}); probe_count by "
        f"route and mode {rep['probe_modes']}")
    return rep, shapes


def mesh_steps(torch, np, cat, mods, model, single_rows, grid_cat, grid_oracle,
               rep) -> dict:
    """phase_mesh's four steps; their launches go into rep["launches"]."""
    from tidb_tpu_torch.parallel import executor as pex
    from tidb_tpu_torch.parallel import make_mesh
    from tidb_tpu_torch.parallel.partition import table_bytes
    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.server.client import Client
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.tpch_queries import Q
    from tidb_tpu_torch.utils import jitcache
    from tidb_tpu_torch.utils.metrics import FRAGMENT_DISPATCH

    # -- 1. a mesh of the one card, as the reference serves one chip --------
    mesh1 = make_mesh()
    label1 = f"mesh {mesh1.shape['dcn']}x{mesh1.shape['shard']}"
    t0 = time.perf_counter()
    s1 = Session(cat, mesh=mesh1)
    rep["mesh1"] = mesh_five(np, s1, mods, model, single_rows, label1, rep)
    rep["mesh1"]["s"] = time.perf_counter() - t0
    rep["mesh1"]["mesh"] = repr(mesh1)
    rep["mix"] = mesh_mix(s1, mods, rep["mesh1"]["rows"], rep)

    # -- 2. streaming: lineitem above tidb_device_cache_bytes ---------------
    li = cat.table("test", "lineitem")
    budget = table_bytes(li) // 4
    s1.execute(f"set tidb_device_cache_bytes = {budget}")
    stream = {"budget_bytes": budget, "lineitem_bytes": table_bytes(li)}
    try:
        for q in ("q1", "q6"):
            sql = Q[q][0]
            with jitcache.eager():
                before = FRAGMENT_DISPATCH.value(kind="scan_agg_stream")
                rows, c, dt = run_query(s1, mods, sql)
                mesh_launches_add(rep["launches"], c["launches"])
                batches = FRAGMENT_DISPATCH.value(kind="scan_agg_stream") - before
                if batches < 2 or not c["launches"]["segagg"]:
                    raise AssertionError(f"mesh stream {q}: {batches} streamed batches, "
                                         f"launches {c['launches']}")
                if rows != rep["mesh1"]["rows"][q]:
                    raise AssertionError(f"mesh stream {q}: rows differ from the resident run")
            graphs = mesh_graph_runs(s1, mods, sql, f"mesh stream {q}", rows)
            for r in graphs["runs"] + [graphs["eager"]]:
                mesh_launches_add(rep["launches"], r["launches"])
            last = graphs["runs"][-1]["programs"]
            # every batch replays its fragment, every merge after the first
            # batch's the aggcombine program
            if (last.get("distagg", {}).get("replay") != batches
                    or last.get("aggcombine", {}).get("replay") != batches - 1):
                raise AssertionError(f"mesh stream {q}: {batches} batches, replayed {last}")
            stream[q] = {"s": dt, "batches": batches, "launches": c["launches"],
                         "graphs": graphs}
            log(f"mesh stream {q}: {batches} batches in {dt * 1e3:.3f} ms equal the "
                f"resident run, eagerly and by replay; launches {c['launches']['segagg']} "
                f"tidb_segagg; graph runs {[r['programs'] for r in graphs['runs']]}; graph "
                f"bytes {graphs['graph_bytes']}")
    finally:
        s1.execute("set tidb_device_cache_bytes = 8589934592")
    rep["stream"] = stream
    rep["retire"] = mesh_retire(torch, s1, mods, rep["mesh1"]["rows"]["q1"])

    # -- 3. four shards on the one card ------------------------------------
    dev = mesh1.device_of(0)
    mesh4 = make_mesh(n_shards=MESH_SHARDS, devices=[dev] * MESH_SHARDS)
    t0 = time.perf_counter()
    s4 = Session(cat, mesh=mesh4)
    rep["mesh4"] = mesh_five(np, s4, mods, model, single_rows,
                             f"mesh 1x{MESH_SHARDS}", rep)
    rep["mesh4"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    g4 = Session(grid_cat, chunk_capacity=8192, mesh=mesh4)
    for name, (sql, osql) in Q.items():
        want = grid_oracle.execute(osql or sql).fetchall()
        # the programs' warm-ups, then (MESH_GRID_RECHECK) their captures
        # and replays
        for run in ((1, 2, 3) if name in MESH_GRID_RECHECK else (1,)):
            rows, c, dt = run_query(g4, mods, sql)
            mesh_launches_add(rep["launches"], c["launches"])
            ok, msg = rows_equal(rows, want)
            if not ok:
                raise AssertionError(f"mesh grid {name} run {run}: {msg}")
        if name in MESH_GRID_RECHECK and not any(
                r.get("replay") for r in _mesh_progs(c["programs"]).values()):
            raise AssertionError(f"mesh grid {name}: the third run replayed no program: "
                                 f"{c['programs']}")
        classes = [k for k in mesh_classes(g4, sql) if k in mesh_executor_names()]
        rep["grid"][name] = {"rows": len(rows), "s": dt, "dist": classes,
                             "launches": {k: v for k, v in c["launches"].items() if v},
                             "programs": _mesh_progs(c["programs"])}
    rep["grid_s"] = time.perf_counter() - t0
    log(f"mesh grid: all 22 queries at SF0.1 on {MESH_SHARDS} shards equal sqlite "
        f"(warm-ups; {MESH_GRID_RECHECK} twice more: captures, replays) in "
        f"{rep['grid_s']:.1f} s; on the mesh: "
        f"{sorted(q for q, v in rep['grid'].items() if v['dist'])}; the last runs' mesh "
        f"programs { {q: v['programs'] for q, v in rep['grid'].items() if v['programs']} }")

    # -- 4. the server with the one-card mesh --------------------------------
    srv = Server(catalog=cat, port=0, status_port=None, mesh=mesh1)
    srv.start()
    wire = {}
    try:
        cl = Client(port=srv.port, timeout=600)
        for q in ("q1", "q3"):
            seg_mod, hp = mods[0], mods[1]
            seg_mod.reset_launches()
            hp.reset_launches()
            t0 = time.perf_counter()
            _names, rows = cl.query(Q[q][0])
            dt = time.perf_counter() - t0
            mesh_launches_add(rep["launches"], {**seg_mod.LAUNCHES, **hp.LAUNCHES})
            if _typed(q, rows) != rep["mesh1"]["rows"][q]:
                raise AssertionError(f"mesh server {q}: wire rows differ from in-process")
            wire[q] = {"s": dt, "launches": {**seg_mod.LAUNCHES, **hp.LAUNCHES}}
            log(f"mesh server {q}: {len(rows)} rows over the wire equal in-process "
                f"in {dt * 1e3:.3f} ms")
        cl.close()
        wire["point_select"] = mesh_server_points(np, cat, srv)
        wire["memory"] = mesh_server_memory(torch, srv, rep["mesh1"]["rows"]["q6"])
    finally:
        srv.shutdown(drain=True)
    rep["server"] = wire

    rep["fallbacks"] = dict(pex.FALLBACKS)
    if not rep["launches"].get("segagg") or not rep["launches"].get("probe_count"):
        raise AssertionError(f"mesh phase launches: {rep['launches']}")
    for sess in (s1, s4, g4):
        sess._shard_cache.clear_tables()
    del s1, s4, g4
    torch.cuda.empty_cache()
    return {}


def sharding_bytes(st) -> int:
    """Device bytes of a ShardedTable's tensors (data, validity, live mask)."""
    ts = [t for d in (st.data, st.valid) for parts in d.values() for t in parts] + list(st.sel)
    return sum(t.numel() * t.element_size() for t in ts)


def mesh_retire(torch, s, mods, q1_rows) -> dict:
    """An UPDATE of lineitem (the last order's quantities up by one, then
    back) retires the mesh session's resident sharding of it: its programs
    must leave the built-program cache and its device memory must be
    returned (the card's allocated bytes after Q1 on the new sharding
    within half a sharding of the bytes before the UPDATE), and Q1 by
    replay on the new sharding equals the resident run's rows."""
    import gc

    from tidb_tpu_torch.storage.tpch_queries import Q
    from tidb_tpu_torch.utils import jitcache

    li = s.catalog.table("test", "lineitem")
    sql = Q["q1"][0]
    # a live order (the refresh phase's RF2 deleted the oldest)
    key = int(s.query("select max(l_orderkey) from lineitem")[0][0])
    for _ in range(3):  # resident again after the streaming step evicted it
        if s.query(sql) != q1_rows:
            raise AssertionError("mesh retire: resident Q1 differs before the UPDATE")
    st = s._shard_cache.get(li)
    old, nbytes = st.serial, sharding_bytes(st)
    held = len(jitcache.programs(owner=old))
    if not held:
        raise AssertionError("mesh retire: no program reads lineitem's resident sharding")
    del st
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    s.execute(f"update lineitem set l_quantity = l_quantity + 1 where l_orderkey = {key}")
    s.execute(f"update lineitem set l_quantity = l_quantity - 1 where l_orderkey = {key}")
    update_s = time.perf_counter() - t0
    runs = []
    for _ in range(3):  # the new sharding's warm-up, capture and replay
        rows, c, _dt = run_query(s, mods, sql)
        runs.append(_mesh_progs(c["programs"]))
        if rows != q1_rows:
            raise AssertionError("mesh retire: Q1 after the UPDATE differs from before it")
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    left = len(jitcache.programs(owner=old))
    new = s._shard_cache.get(li).serial
    if left or new == old:
        raise AssertionError(f"mesh retire: {left} programs of the retired sharding left "
                             f"(serial {old} -> {new})")
    if set(runs[-1].get("distagg", {})) != {"replay"}:
        raise AssertionError(f"mesh retire: Q1 on the new sharding ran {runs}")
    if after - before > nbytes // 2:
        raise AssertionError(f"mesh retire: {after - before} B more allocated after the "
                             f"UPDATE; the sharding is {nbytes} B: the retired one is pinned")
    out = {"sharding_bytes": nbytes, "programs_before": held, "programs_left": left,
           "allocated_before": before, "allocated_after": after, "update_s": update_s,
           "runs": runs}
    log(f"mesh retire: the UPDATE retired lineitem's sharding ({nbytes} B) and its "
        f"{held} programs (0 left); allocated {before} -> {after} B; Q1 on the new "
        f"sharding {runs}")
    return out


def mesh_server_points(np, cat, srv) -> dict:
    """The point-select fleet against the mesh server: every row equal to
    numpy's, and no statement batched (a mesh session offers the batcher no
    probe, as the reference's does). Then the same fleet against a server
    without a mesh with the batcher off (tidb_tpu_batch_window_us = 0),
    which isolates the mesh's cost from the batcher's absence. Returns
    both runs' rates and latencies."""
    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.utils import metrics as M

    def fleet_on(port, label):
        b0 = M.BATCH_SIZE.count()
        fleet = point_fleet(np, cat, port, POINT_CONNS, MESH_POINT_STMTS)
        batches = M.BATCH_SIZE.count() - b0
        if batches:
            raise AssertionError(f"{label}: {batches} point-select batches")
        flat, n_all, wall = fleet["latency_s"], fleet["statements"], fleet["wall_s"]
        out = {"connections": POINT_CONNS, "statements": n_all,
               "absent": fleet["absent"], "wall_s": wall, "stmts_per_s": n_all / wall,
               "p50_ms": _pct(flat, 0.50) * 1e3, "p99_ms": _pct(flat, 0.99) * 1e3}
        log(f"{label} point-selects: {n_all} ({fleet['absent']} absent) from "
            f"{POINT_CONNS} connections in {wall:.3f} s = {out['stmts_per_s']:.1f} "
            f"stmt/s, p50 {out['p50_ms']:.3f} ms p99 {out['p99_ms']:.3f} ms; no batch")
        return out

    out = {"mesh": fleet_on(srv.port, "mesh server")}
    had = "tidb_tpu_batch_window_us" in cat.global_vars
    prev = cat.global_vars.get("tidb_tpu_batch_window_us")
    cat.global_vars["tidb_tpu_batch_window_us"] = 0
    single = Server(catalog=cat, port=0, status_port=None)
    single.start()
    try:
        out["single_unbatched"] = fleet_on(single.port, "single-card server, no batcher,")
    finally:
        single.shutdown(drain=True)
        if had:
            cat.global_vars["tidb_tpu_batch_window_us"] = prev
        else:
            del cat.global_vars["tidb_tpu_batch_window_us"]
    return out


def mesh_server_memory(torch, srv, q6_rows) -> dict:
    """MESH_MEM_CONNS connections to the mesh server each run Q6 three
    times (rows equal to the in-process mesh run's; the third by replay):
    each connection's Session stages its own sharding of lineitem and its
    own graphs, so the card's allocated bytes and the graphs' grow with
    the connections. Returns per connection the bytes after its Q6s, its
    captures and the graphs' bytes, the peak, and the bytes once the
    connections closed."""
    import gc

    from tidb_tpu_torch.server.client import Client
    from tidb_tpu_torch.storage.tpch_queries import Q
    from tidb_tpu_torch.utils import jitcache

    torch.cuda.synchronize()
    gc.collect()
    base = torch.cuda.memory_allocated()
    graphs0 = jitcache.resident_bytes()
    torch.cuda.reset_peak_memory_stats()
    after, captures, graph_bytes, conns = [], [], [], []
    try:
        for _ in range(MESH_MEM_CONNS):
            cl = Client(port=srv.port, timeout=600)
            conns.append(cl)
            jitcache.reset_runs()
            for _run in range(3):
                _names, rows = cl.query(Q["q6"][0])
                if _typed("q6", rows) != q6_rows:
                    raise AssertionError("mesh server q6: wire rows differ from in-process")
            captures.append(sum(r.get("capture", 0) for r in
                                _mesh_progs(jitcache.runs()).values()))
            torch.cuda.synchronize()
            after.append(torch.cuda.memory_allocated() - base)
            graph_bytes.append(jitcache.resident_bytes() - graphs0)
    finally:
        for cl in conns:
            cl.close()
    peak = torch.cuda.max_memory_allocated() - base
    time.sleep(0.5)  # the connection threads drop their sessions
    gc.collect()
    closed = torch.cuda.memory_allocated() - base
    out = {"connections": MESH_MEM_CONNS, "base_bytes": base,
           "allocated_after_each_bytes": after, "peak_bytes": peak,
           "after_close_bytes": closed, "captures_each": captures,
           "graph_bytes_after_each": graph_bytes,
           "graph_bytes_after_close": jitcache.resident_bytes() - graphs0}
    if any(c < 1 for c in captures):
        raise AssertionError(f"mesh server memory: a connection's Q6 captured no graph: "
                             f"{captures}")
    log(f"mesh server memory: {MESH_MEM_CONNS} connections' Q6 (three runs each) add "
        f"{after} B over {base} B allocated (peak +{peak} B); +{closed} B once they "
        f"closed; captures per connection {captures}; graph bytes after each {graph_bytes}, "
        f"{out['graph_bytes_after_close']} once they closed")
    return out


def mesh_kernel_rows(torch, hp, seg_mod, launches: dict, probe_modes: dict,
                     shapes: dict) -> list:
    """The kernels-line rows at the mesh path's own shapes: tidb_segagg on
    its largest mesh call (Q1 on the one-card mesh: one shard is all of
    lineitem) and tidb_probe_count on the largest call of every route and
    mode the mesh took, each checked against its plain version and timed.
    Each row's launches are the mesh phase's for that kernel and route."""
    rows = []
    if shapes.get("segagg") is not None:
        seg, G, sel, accs = shapes["segagg"]
        rows.append(segagg_call_row(torch, seg_mod, "segagg.mesh", seg, G, sel, accs,
                                    launches.get("segagg", 0)))
    for mode, n in sorted(probe_modes.items()):
        args, kw = shapes[mode]
        rows.append(probe_chunk_row(torch, hp, f"probe_count.mesh_{mode.replace('/', '_')}",
                                    args, kw, n, calls=4, reps=3))
    return rows


def segagg_call_row(torch, seg_mod, name, seg, G, sel, accs, launches: int) -> dict:
    """The kernels-line row of tidb_segagg on one recorded call: checked
    bit-equal to plain_segment_accumulate, then timed beside the plain
    version and one index_add_ of every output's per-row contributions.
    Its bound reads each distinct input tensor once and writes each
    output once, one add per row and output."""
    check_segagg_case(torch, seg_mod, seg, G, sel, accs)
    R = seg.shape[0]
    n_out = sum(2 if a.kind == "limbs" else 1 for a in accs)
    ins = {t.data_ptr(): t.numel() * t.element_size()
           for t in [seg, sel] + [x for a in accs for x in (a.vals, a.mask)]
           if t is not None}
    nbytes = sum(ins.values()) + n_out * G * 8
    # the library yardstick's operand: each output's per-row contribution
    base = torch.ones(R, dtype=torch.bool, device=seg.device) if sel is None else sel
    cols = []
    for a in accs:
        live = base if a.mask is None else base & a.mask
        if a.kind == "count":
            cols.append(live.to(torch.int64))
        elif a.kind == "sum":
            cols.append(torch.where(live, a.vals, 0))
        else:
            v = torch.where(live, a.vals, 0)
            cols += [v & 0xFFFFFFFF, v >> 32]
    stacked = torch.stack(cols, 1).contiguous()
    idx = seg.to(torch.int64)
    lib = torch.zeros(G, n_out, dtype=torch.int64, device=seg.device)
    ms = device_ms(torch, lambda: seg_mod.segment_accumulate(seg, G, sel, accs),
                   graph=True, calls=4, reps=3)
    plain_ms = device_ms(torch, lambda: seg_mod.plain_segment_accumulate(seg, G, sel, accs),
                         graph=False, calls=4, reps=3)
    library_ms = device_ms(torch, lambda: lib.index_add_(0, idx, stacked), graph=True,
                           calls=4, reps=3)
    del stacked, lib
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = R * n_out / SCALAR_OPS_PER_S * 1e3
    row = {"name": name, "route": "cuda", "source": "tidb_tpu_torch/ops/csrc/segment_sum.cu",
           "replaces": "tidb_tpu/ops/segment_sum.py:177",
           "also_replaces": "tidb_tpu/ops/segment_sum.py:112",
           "launches": launches, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms}
    log(f"{name} at R={R} G={G}, {len(accs)} accumulators ({n_out} outputs): "
        f"{ms * 1e3:.2f} us/call, bound {row['bound_ms'] * 1e3:.3f} us ({nbytes} B), "
        f"plain {plain_ms * 1e3:.2f} us, index_add_ [R, {n_out}] {library_ms * 1e3:.2f} us; "
        f"{launches} mesh launches")
    return row


def has_eager_partial(plan) -> bool:
    """Does the physical plan carry an eager-aggregation partial (an
    aggregation whose outputs carry the rule's derived `eagg.` uids, as
    plan feedback's harvest reads it)?"""
    from tidb_tpu_torch.planner.physical import PHashAgg

    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, PHashAgg) and any(a.uid.startswith("eagg.")
                                              for a in node.aggs):
            return True
        stack.extend(node.children)
    return False


# ---------------------------------------------------------------------------
# the DCN tier: worker processes on the card, SHARD BY, 2PC, online reshard
# ---------------------------------------------------------------------------

DCN_WORKERS = 2                # worker processes, each a CUDA context on the card
DCN_SHARDS = 8                 # lineitem and orders: SHARD BY HASH(key) SHARDS 8
# orders' new shard count: 9 breaks the co-location with lineitem at two
# workers (12 would keep it: (mix(k) % 12) % 2 == mix(k) % 2), so Q3
# afterwards has to shuffle orders
DCN_RESHARDS = 9
DCN_BROADCAST = ("customer", "supplier", "nation", "region")
DCN_QUERIES = ("q1", "q6", "q3", "q5")
DCN_WARM = 1                  # warm runs of each query (3 before the SF10 phase)
# the membership and failover fleets hold orders up to this quantile of
# o_orderkey (all of orders before the SF10 phase took its share of the
# time limit: their loads and shard moves took 53 s at SF1)
DCN_SIDE_SHARE = 0.25
DCN_KEY = {"lineitem": "l_orderkey", "orders": "o_orderkey"}
DCN_WRITER_BASE = 10 ** 9     # the reshard writer's order keys start here
DCN_DEADLINE_MS = 20          # max_execution_time of the deadline step's Q1
DCN_WORKER_THREADS = 2        # torch's CPU threads in each worker process
DCN_GATE_WAIT_S = 300.0       # the fleet's bound on a statement's gate wait


def dcn_start_workers(n: int, device: str, env: dict, procs: list) -> list:
    """n worker processes (python -m tidb_tpu_torch.parallel.dcn), started
    together; each is appended to `procs` as it starts (the caller stops
    them). Returns their ports."""
    here = os.path.dirname(os.path.abspath(__file__))
    started = []
    for _ in range(n):
        p = subprocess.Popen([sys.executable, "-m", "tidb_tpu_torch.parallel.dcn",
                              "--device", device], stdout=subprocess.PIPE, text=True,
                             cwd=here, env=env)
        procs.append(p)
        started.append(p)
    ports = []
    for p in started:
        line = p.stdout.readline()
        m = re.search(r"DCN_WORKER_PORT=(\d+)", line)
        if not m:
            raise AssertionError(f"a DCN worker did not start (exit {p.poll()}): {line!r}")
        ports.append(int(m.group(1)))
    return ports


def dcn_stop(procs: list) -> list:
    """Wait for every worker process (a Cluster.shutdown ends them), kill
    the ones still running after 30 s; returns the pids that had to be
    killed."""
    killed = []
    deadline = time.monotonic() + 30
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            killed.append(p.pid)
    return killed


def dcn_time_shards(cl, acc: dict) -> None:
    """Time each shard's backfill and cutover step of a Cluster's online
    reshards into acc["backfill"] and acc["cutover"] (seconds)."""
    for step in acc:
        real = getattr(cl, f"_{step}_shard")

        def timed_step(*a, _real=real, _acc=acc[step], **kw):
            t1 = time.perf_counter()
            try:
                return _real(*a, **kw)
            finally:
                _acc.append(time.perf_counter() - t1)

        setattr(cl, f"_{step}_shard", timed_step)


def dcn_shutdown_worker(port: int) -> None:
    """Send one worker outside every Cluster (a removed one) its
    shutdown."""
    from tidb_tpu_torch.parallel import dcn

    sock = dcn.dial("127.0.0.1", port, timeout=30)
    try:
        dcn._send(sock, {"cmd": "shutdown"})
        dcn._recv(sock)
    finally:
        sock.close()


def dcn_orders_share(np, cat) -> tuple:
    """orders' live rows up to DCN_SIDE_SHARE of the order keys, extracted
    for a side fleet: (arrays, valids, strings, rows, the largest key)."""
    from tidb_tpu_torch.sharding.shuffle import extract_rows

    o = cat.table("test", "orders")
    n = o.n
    live = o.live_mask(0, n)
    keys = o.data["o_orderkey"][:n]
    kmax = int(np.sort(keys[live])[int(live.sum() * DCN_SIDE_SHARE) - 1])
    idx = np.nonzero(live & (keys <= kmax))[0]
    arrays, valids, strings = extract_rows(o, idx)
    return arrays, valids, strings, len(idx), kmax


def dcn_table_ddl(s, name: str, shard_key=None, shards: int = DCN_SHARDS) -> str:
    """CREATE TABLE for a fleet copy of `name`: every column of the
    single-card table as SHOW CREATE TABLE gives it (no key or index:
    loads skip the unique checks), SHARD BY HASH(shard_key) if given."""
    text = s.query(f"show create table {name}")[0][1]
    cols = [ln.rstrip(",") for ln in text.splitlines()[1:] if ln.startswith("  `")]
    ddl = f"create table {name} (\n" + ",\n".join(cols) + "\n)"
    if shard_key:
        ddl += f" shard by hash({shard_key}) shards {shards}"
    return ddl


def dcn_worker_counts(cl) -> list:
    """Per worker {"launches": {entry: n}, "routes": {route: n}} from its
    own counters, read over the metrics_snapshot RPC."""
    out = []
    for _label, snap, err in cl.metrics_snapshots():
        if snap is None:
            out.append(None)
            continue
        got = {"launches": {}, "routes": {}}
        for m in snap["metrics"]:
            if m["name"] == "tidb_tpu_device_dispatch_total":
                got["launches"] = {lb.get("site"): int(v) for lb, v in m["samples"]}
            elif m["name"] == "tidb_tpu_join_probe_mode_total":
                got["routes"] = {lb.get("mode"): int(v) for lb, v in m["samples"]}
        out.append(got)
    return out


def dcn_delta(before: list, after: list) -> list:
    """Per worker the counts `after` minus `before` (None for a worker
    that did not answer either time)."""
    out = []
    for b, a in zip(before, after):
        if a is None or b is None:
            out.append(None)
            continue
        out.append({k: {e: a[k].get(e, 0) - b[k].get(e, 0)
                        for e in set(a[k]) | set(b[k]) if a[k].get(e, 0) - b[k].get(e, 0)}
                    for k in ("launches", "routes")})
    return out


def dcn_add(total: dict, delta: list) -> None:
    for d in delta:
        if d is None:
            continue
        for k in ("launches", "routes"):
            for e, v in d[k].items():
                total[k][e] = total[k].get(e, 0) + v


def dcn_same(label: str, got, want) -> None:
    """Rows equal, floats within 1e-12 relative (decimals are exact
    strings; AVG is finalized from exact sums on either side)."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} rows against {len(want)}")
    for g, w in zip(got, want):
        if len(g) != len(w):
            raise AssertionError(f"{label}: row width {g} vs {w}")
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                if not abs(a - b) <= 1e-12 * max(abs(a), abs(b)):
                    raise AssertionError(f"{label}: {g} vs {w}")
            elif a != b:
                raise AssertionError(f"{label}: {g} vs {w}")


def dcn_device_memory(torch, procs: list) -> dict:
    """Device memory of each worker process as nvidia-smi lists it (used
    memory, the CUDA context and the caching allocator's pool included:
    torch.cuda.memory_allocated can be read only inside the process),
    and the card's used bytes (torch.cuda.mem_get_info)."""
    out = {"per_process_mib": {}, "card_used_bytes": None}
    try:
        r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                            "--format=csv,noheader,nounits"], capture_output=True,
                           text=True, timeout=30)
        pids = {p.pid for p in procs}
        for ln in r.stdout.strip().splitlines():
            pid, mib = [x.strip() for x in ln.split(",")[:2]]
            if pid.isdigit() and int(pid) in pids:
                out["per_process_mib"][int(pid)] = int(mib)
    except Exception as e:  # noqa: BLE001 — reported, not fatal
        out["error"] = f"{type(e).__name__}: {e}"
    if torch.cuda.is_available():
        free, total = torch.cuda.mem_get_info()
        out["card_used_bytes"] = int(total - free)
    return out


def phase_dcn(torch, np, s, sf: float = 1.0, device: str = "cuda") -> dict:
    """The DCN tier at SF`sf` (item 10 of the module docstring) beside the
    single-card session `s` (the last phase; `s` keeps its rows: the
    fleet's DML is checked against a numpy model). Every step fails the
    run on a wrong answer; every worker process is stopped before it
    returns. Returns the report: "launches" and "routes" count the
    workers' own launches over the phase's query runs, "coordinator"
    this process's (the merge session's) over the same runs, and
    "probe_modes" the route and mode of every probe_count launch."""
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dcn_")
    # several workers share this host's cores: each takes a few torch
    # threads (eight apiece oversubscribe them, and the spinning OpenMP
    # pools slowed a CPU rehearsal's Q1 from 0.2 s to 7 s)
    env = dict(os.environ, TMPDIR=tmp, OMP_NUM_THREADS=str(DCN_WORKER_THREADS))
    procs: list = []
    clusters: list = []
    rep = {"card": card_line(), "launches": {}, "routes": {}, "sf": sf,
           "coordinator": {"launches": {}, "routes": {}}}
    try:
        dcn_steps(torch, np, s, sf, device, env, procs, clusters, rep)
    finally:
        for cl in clusters:
            try:
                cl.shutdown()
            except Exception:  # noqa: BLE001 — a killed worker's link
                pass
        killed = dcn_stop(procs)
    rep["killed_at_shutdown"] = killed
    alive = [p.pid for p in procs if p.poll() is None]
    left = sorted(os.listdir(tmp))
    if alive or left:
        raise AssertionError(f"DCN shutdown left workers {alive} or files {left}")
    os.rmdir(tmp)
    rep["s"] = time.perf_counter() - t_phase
    # the route and mode of each probe_count launch: the workers' metric
    # counts routes alone, and a flags-only probe is made only for an
    # unfiltered semi or anti join, which dcn_steps checks no DCN query
    # plans, so every route's launches probe in full
    rep["probe_modes"] = {f"{r}/full": n for c in (rep, rep["coordinator"])
                          for r, n in c["routes"].items() if n}
    log(f"dcn phase passed in {rep['s']:.1f} s: no worker process and no spill file "
        f"left; workers' launches {rep['launches']}, probe routes {rep['routes']}; "
        f"the coordinator's launches {rep['coordinator']['launches']}, probe routes "
        f"{rep['coordinator']['routes']}")
    return rep


def dcn_row_launches(rows: list, dcn: dict) -> None:
    """Set each kernels-line row's launches_dcn: the DCN phase's launches
    of the workers and the coordinator together, tidb_probe_count's on the
    row of its route and mode at the main path's shapes (PROBE_ROW_MODES),
    the rows at other shapes (the mesh's, a synthetic table) at 0. Fails if
    a launch of the phase has no row to sit on."""
    sites = {}
    for c in (dcn, dcn["coordinator"]):
        for site, n in c["launches"].items():
            sites[site] = sites.get(site, 0) + n
    modes = dcn["probe_modes"]
    placed = {}
    for row in rows:
        name = row["name"]
        if name.startswith("probe_count."):
            row["launches_dcn"] = modes.get(PROBE_ROW_MODES.get(name), 0)
            placed["probe_count"] = placed.get("probe_count", 0) + row["launches_dcn"]
        elif name in sites:
            row["launches_dcn"] = sites[name]
            placed[name] = sites[name]
        else:
            row["launches_dcn"] = 0
    lost = {k: (v, placed.get(k, 0)) for k, v in sites.items() if v != placed.get(k, 0)}
    if lost or set(modes) - set(PROBE_ROW_MODES.values()):
        raise AssertionError(f"dcn launches with no kernels-line row: {lost} (launched, "
                             f"placed); probe modes {modes}")


def dcn_coordinator_counts() -> list:
    """This process's counters in dcn_worker_counts's form (one entry):
    the coordinator's merge session launches here."""
    from tidb_tpu_torch.ops import hash_probe as hp
    from tidb_tpu_torch.ops import join_kernels as jk
    from tidb_tpu_torch.ops import segment_sum as seg_mod

    return [{"launches": {**seg_mod.LAUNCHES, **hp.LAUNCHES},
             "routes": dict(jk.PROBE_ROUTES)}]


def dcn_no_flags_only_probe(s, queries) -> None:
    """Fail if a query's plan holds an unfiltered semi or anti join, the one
    join that probes flags only: the workers' probe metric counts routes,
    not modes, and phase_dcn puts every route's launches on its full-mode
    row."""
    from tidb_tpu_torch.planner.physical import PHashJoin
    from tidb_tpu_torch.storage.tpch_queries import Q

    for q in queries:
        stack = [planned(s, Q[q][0])]
        while stack:
            node = stack.pop()
            if isinstance(node, PHashJoin) and node.kind in ("semi", "anti"):
                raise AssertionError(f"dcn {q} plans a {node.kind} join: its probes' "
                                     "mode cannot be read off the workers' route counts")
            stack.extend(node.children)


def dcn_steps(torch, np, s, sf, device, env, procs, clusters, rep) -> None:
    import threading

    from tidb_tpu_torch.errors import QueryTimeoutError
    from tidb_tpu_torch.parallel.dcn import Cluster
    from tidb_tpu_torch.sharding.shuffle import extract_live_columns
    from tidb_tpu_torch.storage import tpch_refresh as rf
    from tidb_tpu_torch.storage.tpch_queries import Q
    from tidb_tpu_torch.utils.metrics import DCN_BYTES, DCN_FAILOVER_TOTAL

    cat = s.catalog.base
    s.execute("use test")
    model = ArrayModel(np, cat)

    # 1. two worker processes on the card, one replica-free fleet; the
    # membership fleet of step 8 and its joiner, and the replica fleet of
    # step 9, start with them
    t0 = time.perf_counter()
    started = dcn_start_workers(3 * DCN_WORKERS + 1, device, env, procs)
    ports, ports3, ports_m, ports_b = (
        started[:DCN_WORKERS], started[DCN_WORKERS:DCN_WORKERS + 1],
        started[DCN_WORKERS + 1:2 * DCN_WORKERS + 1], started[2 * DCN_WORKERS + 1:])
    proc_b1 = procs[-1]
    cl = Cluster([("127.0.0.1", p) for p in ports], device=device,
                 rpc_timeout_s=600.0, connect_timeout_s=60.0)
    clusters.append(cl)
    # a statement issued during the reshard can wait for all of it: its
    # per-shard write windows follow one another and a waiting writer
    # keeps new readers out, about 13 s for orders at SF1, past the
    # default bound (tidb_tpu_reshard_gate_wait_ms's 10 s), under which
    # the reshard's readers fail typed (ROADMAP Queue C); the reshard
    # step prints its slowest statement beside that default
    cl.GATE_WAIT_S = DCN_GATE_WAIT_S
    # the workers' commits do not auto-analyze (RF1's would analyze
    # lineitem and orders on every owner, as phase_refresh measures)
    cl.broadcast_exec("set tidb_enable_auto_analyze = 0")
    shard_s = {"backfill": [], "cutover": []}
    dcn_time_shards(cl, shard_s)
    rep["start_s"] = time.perf_counter() - t0
    log(f"dcn: {len(started)} worker processes (--device {device}) up in "
        f"{rep['start_s']:.1f} s on ports {started}; the fleet is {ports}")

    # 2. lineitem and orders SHARD BY HASH(key) SHARDS 8 (co-partitioned),
    # the four dimensions broadcast; every column of the single-card tables
    loads = rep["loads"] = {}
    for name in ("lineitem", "orders") + DCN_BROADCAST:
        t = cat.table("test", name)
        t0 = time.perf_counter()
        arrays, valids, strings, n = extract_live_columns(t)
        t_extract = time.perf_counter() - t0
        key = DCN_KEY.get(name)
        cl.ddl(dcn_table_ddl(s, name, key))
        sent0 = DCN_BYTES.value(direction="sent")
        t0 = time.perf_counter()
        if key:
            got = cl.load_sharded(name, arrays=arrays, valids=valids, strings=strings)
        else:
            got = cl.broadcast_table(name, arrays=arrays, valids=valids, strings=strings)
        dt = time.perf_counter() - t0
        if got != n:
            raise AssertionError(f"dcn load of {name}: {got} rows landed, {n} sent")
        loads[name] = {"rows": n, "columns": len(t.schema.columns), "extract_s": t_extract,
                       "load_s": dt, "wire_bytes": DCN_BYTES.value(direction="sent") - sent0}
        log(f"dcn load {name}: {n} rows x {len(t.schema.columns)} columns in {dt:.3f} s "
            f"({'sharded' if key else 'broadcast'}; extract {t_extract:.3f} s), "
            f"{loads[name]['wire_bytes']:.0f} B on the wire")
        del arrays, valids, strings
    rep["memory_after_load"] = mem = dcn_device_memory(torch, procs)
    log(f"dcn device memory after the load: per worker process (nvidia-smi MiB) "
        f"{mem['per_process_mib']}, card used {mem['card_used_bytes']} B")

    # 3. Q1, Q6, Q3, Q5: one cold run and DCN_WARM warm, each against the
    # single-card session's rows and numpy; each worker's own launches
    single = rep["single_card"] = {}
    single_rows = {}
    for q in DCN_QUERIES:
        single_rows[q] = s.query(Q[q][0])
        warm = []
        for _ in range(DCN_WARM):
            t0 = time.perf_counter()
            s.query(Q[q][0])
            warm.append(time.perf_counter() - t0)
        single[q] = {"warm_s": warm, "warm_median_s": statistics.median(warm)}
    dcn_no_flags_only_probe(s, DCN_QUERIES)
    fleet = rep["queries"] = {}
    for q in DCN_QUERIES:
        runs, per_run, merges = [], [], []
        for i in range(1 + DCN_WARM):
            c0, k0 = dcn_worker_counts(cl), dcn_coordinator_counts()
            t0 = time.perf_counter()
            rows = cl.query(Q[q][0])
            runs.append(time.perf_counter() - t0)
            merge = dcn_delta(k0, dcn_coordinator_counts())
            delta = dcn_delta(c0, dcn_worker_counts(cl))
            dcn_add(rep, delta)
            dcn_add(rep["coordinator"], merge)
            per_run.append(delta)
            merges.append(merge[0])
            dcn_same(f"dcn {q}", rows, single_rows[q])
        first = per_run[0]
        # (a CPU rehearsal's workers run the plain path: no launch)
        if device == "cuda" and q == "q1" and not all(
                d["launches"].get("segagg") for d in first):
            raise AssertionError(f"dcn q1: a worker's partial launched no tidb_segagg: {first}")
        if device == "cuda" and q == "q3" and not all(
                d["launches"].get("probe_count") for d in first):
            raise AssertionError(f"dcn q3: a worker launched no tidb_probe_count: {first}")
        if device == "cuda" and q == "q1" and not merges[0]["launches"].get("segagg"):
            raise AssertionError(f"dcn q1: the coordinator's final merge launched no "
                                 f"tidb_segagg: {merges[0]}")
        fleet[q] = {"cold_s": runs[0], "warm_s": runs[1:],
                    "warm_median_s": statistics.median(runs[1:]), "workers": per_run,
                    "coordinator": merges}
        log(f"dcn {q}: rows equal the single-card session's; cold {runs[0] * 1e3:.3f} ms, "
            f"warm median {fleet[q]['warm_median_s'] * 1e3:.3f} ms "
            f"{[round(r * 1e3, 3) for r in runs[1:]]} (single card "
            f"{single[q]['warm_median_s'] * 1e3:.3f} ms); workers' first run {first}; "
            f"the coordinator's merge {merges[0]}")
    check_q1(np, single_rows["q1"], numpy_q1(np, model.table("test", "lineitem")))
    if _scaled(single_rows["q6"][0][0]) != numpy_q6(np, model.table("test", "lineitem")):
        raise AssertionError("dcn q6 differs from numpy")
    check_join_rows("q3", single_rows["q3"], numpy_q3(np, model), {1})
    check_join_rows("q5", single_rows["q5"], numpy_q5(np, model), {1})
    try:
        cl.query(Q["q18"][0])
        raise AssertionError("dcn q18 gave rows where the reference's Cluster refuses it")
    except Exception as e:  # noqa: BLE001 — the typed refusal is the answer
        if type(e).__name__ != "UnsupportedError":
            raise
        rep["q18"] = f"{type(e).__name__}: {e}"
    log(f"dcn: the four equal numpy too; q18 refused as by the reference ({rep['q18']})")

    # 4. online reshard of orders under two readers and a 2PC writer
    read_sql = (f"select o_orderpriority, count(*) as n, sum(o_totalprice) as s from "
                f"orders where o_orderkey < {DCN_WRITER_BASE} group by o_orderpriority "
                f"order by o_orderpriority")
    want = s.query(read_sql)
    stop, lock = threading.Event(), threading.Lock()
    errors, reads, applied, refused = [], [0], [], [0]
    slowest = {"read": 0.0, "write": 0.0}  # seconds, gate waits included

    def took(kind, t0):
        with lock:
            slowest[kind] = max(slowest[kind], time.perf_counter() - t0)

    def transient(e):
        return "pending" in str(e)

    def reader():
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                got = cl.query(read_sql)
            except Exception as e:  # noqa: BLE001 — recorded, fails the step
                took("read", t0)
                with lock:
                    if transient(e):
                        refused[0] += 1
                    else:
                        errors.append(("read", repr(e)))
                continue
            took("read", t0)
            with lock:
                if got != want:
                    errors.append(("mismatch", got[:2]))
                reads[0] += 1

    # the writer's rows copy a live order (every column of the table as it
    # stands) under new keys
    o = cat.table("test", "orders")
    live0 = int(np.nonzero(o.live_mask(0, o.n))[0][0])
    proto = {c: o.data[c][live0:live0 + 1].copy() for c in o.schema.names()}

    def writer():
        i = 0
        while not stop.is_set():
            proto["o_orderkey"][0] = DCN_WRITER_BASE + i
            sql = rf.insert_statements(o, proto)[0]
            i += 1
            t0 = time.perf_counter()
            try:
                cl.execute_dml(sql)
            except Exception as e:  # noqa: BLE001 — recorded, fails the step
                took("write", t0)
                with lock:
                    if transient(e):
                        refused[0] += 1
                    else:
                        errors.append(("write", repr(e)))
                continue
            took("write", t0)
            with lock:
                applied.append(sql)
            time.sleep(0.005)

    threads = [threading.Thread(target=reader) for _ in range(2)] + [
        threading.Thread(target=writer)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.5)
        t0 = time.perf_counter()
        cl.reshard(f"alter table orders shard by hash(o_orderkey) shards {DCN_RESHARDS}")
        t_reshard = time.perf_counter() - t0
        time.sleep(0.5)
    finally:
        stop.set()
        for t in threads:
            t.join(120)
    log(f"dcn reshard: {t_reshard:.3f} s; per shard backfill "
        f"{[round(x, 3) for x in shard_s['backfill']]} s, cutover "
        f"{[round(x, 3) for x in shard_s['cutover']]} s")
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"dcn reshard under traffic: {errors[:5]}")
    if not reads[0] or not applied:
        raise AssertionError(f"dcn reshard: {reads[0]} reads, {len(applied)} writes served")
    if cl.placement("orders").shards != DCN_RESHARDS:
        raise AssertionError("dcn reshard: the new map is not installed")
    n_orders = cl.query("select count(*) as n from orders")[0][0]
    if n_orders != model.tables["orders"].n + len(applied):
        raise AssertionError(f"dcn reshard: orders has {n_orders} rows, the model "
                             f"{model.tables['orders'].n} + {len(applied)} written")
    st0 = cl.worker_stats()
    c0, k0 = dcn_worker_counts(cl), dcn_coordinator_counts()
    rows = cl.query(Q["q3"][0])
    dcn_add(rep["coordinator"], dcn_delta(k0, dcn_coordinator_counts()))
    dcn_add(rep, dcn_delta(c0, dcn_worker_counts(cl)))
    st1 = cl.worker_stats()
    shuffle = {k: sum(b[k] - a[k] for a, b in zip(st0, st1))
               for k in ("shuffle_bytes_in", "shuffle_bytes_out")}
    dcn_same("dcn q3 after the reshard", rows, s.query(Q["q3"][0]))
    check_join_rows("q3", rows, numpy_q3(np, model), {1})
    if not shuffle["shuffle_bytes_in"]:
        raise AssertionError("dcn q3 after the reshard moved no shuffle bytes")
    rep["reshard"] = {"s": t_reshard, "reads": reads[0], "writes": len(applied),
                      "refused_pending": refused[0], "q3_shuffle": shuffle,
                      "slowest_statement_s": dict(slowest),
                      "gate_wait_bound_s": cl.GATE_WAIT_S,
                      "shards": DCN_RESHARDS, "shard_s": copy.deepcopy(shard_s)}
    for acc in shard_s.values():
        acc.clear()
    log(f"dcn reshard: orders {DCN_SHARDS} -> {DCN_RESHARDS} shards online in "
        f"{t_reshard:.3f} s under {reads[0]} reads (each equal) and {len(applied)} 2PC "
        f"writes ({refused[0]} refused as pending and retried); slowest statement "
        f"{slowest} s against a gate bound of {cl.GATE_WAIT_S} s (the default of "
        f"tidb_tpu_reshard_gate_wait_ms is 10 s); Q3 through the shuffle "
        f"equals the single card and numpy, shuffle bytes {shuffle}")

    # 5. TPC-H RF1's rows (SF * 1,500 orders and their lineitems) as
    # multi-row INSERTs and RF2's as DELETEs, each a 2PC over its owners,
    # against the numpy model (the single-card session keeps its rows)
    li = cat.table("test", "lineitem")
    new = rf.rf1(cat, sf, seed=7)
    # one INSERT a table: each statement that brings new strings rebuilds
    # the dictionaries of the tables it writes, on every owner
    inserts = (rf.insert_statements(o, new["orders"], batch=1 << 20)
               + rf.insert_statements(li, new["lineitem"], batch=1 << 20))
    keys = rf.rf2_keys(cat, sf)
    ks = ", ".join(str(int(k)) for k in keys)
    deletes = [f"delete from lineitem where l_orderkey in ({ks})",
               f"delete from orders where o_orderkey in ({ks})"]
    t0 = time.perf_counter()
    parts = [cl.execute_dml(q)["workers"] for q in inserts]
    t_rf1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts += [cl.execute_dml(q)["workers"] for q in deletes]
    t_rf2 = time.perf_counter() - t0
    model.append(new)
    model.drop_orders(keys)
    q1_model = numpy_q1(np, model.table("test", "lineitem"))
    check_q1(np, cl.query(Q["q1"][0]), q1_model)
    if cl._txn_pending or cl._txn_decided:
        raise AssertionError("dcn: 2PC state left after the refresh")
    rep["refresh"] = {"rf1_statements": len(inserts), "rf1_rows": sum(
        len(v[next(iter(v))]) for v in new.values()), "rf1_s": t_rf1,
        "rf2_statements": len(deletes), "rf2_orders": len(keys), "rf2_s": t_rf2,
        "participants": sorted({len(p) for p in parts})}
    log(f"dcn refresh: RF1 {rep['refresh']['rf1_rows']} rows in {len(inserts)} 2PC INSERTs "
        f"({t_rf1:.3f} s), RF2 {len(keys)} orders in {len(deletes)} 2PC DELETEs "
        f"({t_rf2:.3f} s); Q1 equals numpy over the updated tables")

    # 6. the wire witness: the coordinator's sanitizer on for one Q1, one Q3
    # and one 2PC INSERT (and its DELETE): every request those statements
    # send is diffed against the port's committed protocol model
    from tidb_tpu_torch.analysis import sanitizer as san

    san.disable()
    san.enable()
    try:
        check_q1(np, cl.query(Q["q1"][0]), q1_model)
        check_join_rows("q3", cl.query(Q["q3"][0]), numpy_q3(np, model), {1})
        proto["o_orderkey"][0] = 2 * DCN_WRITER_BASE
        wire_parts = cl.execute_dml(rf.insert_statements(o, proto)[0])["workers"]
        cl.execute_dml(f"delete from orders where o_orderkey = {2 * DCN_WRITER_BASE}")
        report = san.report()
    finally:
        san.disable()
    wire = [f for f in report["findings"] if f["kind"].startswith("wire-")]
    if wire:
        raise AssertionError(f"dcn wire witness: {wire[:5]}")
    rep["wire_witness"] = {"findings": report["findings"], "insert_participants":
                           len(wire_parts), "lock_edges": report["lock_edges"]}
    log(f"dcn wire witness: Q1, Q3 and a 2PC INSERT ({len(wire_parts)} participants) and "
        f"DELETE sent no request the protocol model lacks; findings "
        f"{[(f['kind'], f['subject']) for f in report['findings']]}")

    # 7. a statement deadline
    sess = type(s)(catalog=cat, device=s.device)
    sess.execute(f"set max_execution_time = {DCN_DEADLINE_MS}")
    st0 = cl.worker_stats()
    try:
        cl.query(Q["q1"][0], session=sess)
        raise AssertionError(f"dcn: q1 under max_execution_time = {DCN_DEADLINE_MS} "
                             "finished")
    except QueryTimeoutError as e:
        timeout_err = str(e)
    time.sleep(0.5)
    st1 = cl.worker_stats()
    moved = {k: sum(b[k] - a[k] for a, b in zip(st0, st1))
             for k in ("deadline_exceeded", "cancelled", "cancel_rpcs")}
    if not moved["deadline_exceeded"] + moved["cancelled"]:
        raise AssertionError(f"dcn deadline: no worker stopped its partial: {moved}")

    # 8. membership over a fleet of its own holding orders alone (moving
    # lineitem's shards too took 99-107 s: a moved 750,000-row lineitem
    # shard 4-7 s to backfill and as long to cut over, host work): a third
    # worker joins its two and drains out
    clm = Cluster([("127.0.0.1", p) for p in ports_m], device=device,
                  rpc_timeout_s=600.0, connect_timeout_s=60.0)
    clusters.append(clm)
    clm.GATE_WAIT_S = DCN_GATE_WAIT_S
    clm.broadcast_exec("set tidb_enable_auto_analyze = 0")
    mem_s = {"backfill": [], "cutover": []}
    dcn_time_shards(clm, mem_s)
    clm.ddl(dcn_table_ddl(s, "orders", "o_orderkey"))
    arrays, valids, strings, n, side_kmax = dcn_orders_share(np, cat)
    mem_want = (n, int(arrays["o_totalprice"].astype(np.int64).sum()))
    t0 = time.perf_counter()
    clm.load_sharded("orders", arrays=arrays, valids=valids, strings=strings)
    t_mload = time.perf_counter() - t0
    del arrays, valids, strings
    mem_sql = "select count(*) as n, sum(o_totalprice) as s from orders"

    def check_orders(label):
        got = clm.query(mem_sql)
        if len(got) != 1 or (got[0][0], _scaled(got[0][1])) != mem_want:
            raise AssertionError(f"dcn membership {label}: {got} vs numpy {mem_want}")

    check_orders("after the load")
    t0 = time.perf_counter()
    idx = clm.add_worker("127.0.0.1", ports3[0])
    t_add = time.perf_counter() - t0
    check_orders("after add_worker")
    t0 = time.perf_counter()
    clm.remove_worker(idx, graceful=True)
    t_remove = time.perf_counter() - t0
    check_orders("after remove_worker")
    dcn_shutdown_worker(ports3[0])
    rep["membership"] = {"add_s": t_add, "remove_s": t_remove, "shard_s": mem_s,
                         "tables": ["orders"], "load_s": t_mload}
    log(f"dcn membership (a fleet holding orders alone, loaded in {t_mload:.3f} s): "
        f"add_worker {t_add:.3f} s, remove_worker(graceful) {t_remove:.3f} s; orders' "
        f"count and sum equal numpy after each; per moved shard backfill "
        f"{[round(x, 3) for x in mem_s['backfill']]} s, cutover "
        f"{[round(x, 3) for x in mem_s['cutover']]} s")

    # 9. a killed worker under a second fleet whose partitions each have a
    # replica (it holds orders alone: mirroring lineitem and orders through
    # the reshard would re-dump the whole table at every shard's cutover)
    clb = Cluster([("127.0.0.1", p) for p in ports_b], device=device,
                  replicas={0: 1, 1: 0}, rpc_timeout_s=600.0, connect_timeout_s=60.0)
    clusters.append(clb)
    clb.ddl(dcn_table_ddl(s, "orders", "o_orderkey"))
    arrays, valids, strings, n, side_kmax = dcn_orders_share(np, cat)
    t0 = time.perf_counter()
    clb.load_sharded("orders", arrays=arrays, valids=valids, strings=strings)
    t_mirror = time.perf_counter() - t0
    del arrays, valids, strings
    # the fleet holds the share alone: the single card reads the same rows
    fo_sql = ("select o_orderstatus, count(*) as n, sum(o_totalprice) as s, "
              f"min(o_orderdate) as d from orders where o_orderkey <= {side_kmax} "
              "group by o_orderstatus order by o_orderstatus")
    fo_want = s.query(fo_sql)
    dcn_same("dcn failover fleet", clb.query(fo_sql), fo_want)
    proc_b1.kill()
    proc_b1.wait()
    f0 = DCN_FAILOVER_TOTAL.value()
    dcn_same("dcn failover: orders through the replica", clb.query(fo_sql), fo_want)
    read_share = read_sql.replace("where ", f"where o_orderkey <= {side_kmax} and ", 1)
    dcn_same("dcn failover: read_sql through the replica", clb.query(read_share),
             s.query(read_share))
    failovers = DCN_FAILOVER_TOTAL.value() - f0
    if not failovers:
        raise AssertionError("dcn failover: tidb_tpu_dcn_failover_total did not move")
    rep["failures"] = {"deadline_error": timeout_err, "worker_counters": moved,
                       "mirror_load_s": t_mirror, "failovers": failovers}
    log(f"dcn failures: q1 under {DCN_DEADLINE_MS} ms -> QueryTimeoutError, workers "
        f"{moved}; "
        f"orders with replicas loaded in {t_mirror:.3f} s; worker 1 SIGKILLed, two "
        f"statements served through the replica ({failovers:.0f} failovers)")

    # 10. information_schema shows the fleets
    stats = s.query("select cluster, worker, endpoint, state, executed, shards_owned, "
                    "shuffle_bytes_in, error from information_schema.dcn_worker_stats")
    info = s.query("select table_name, workers from information_schema.cluster_info")
    eps = {r[2] for r in stats}
    if not all(f"127.0.0.1:{p}" in eps for p in ports + ports_m + ports_b):
        raise AssertionError(f"dcn_worker_stats misses a worker: {stats}")
    if sum(1 for r in info if r[0] == "__fleet__") < 3:
        raise AssertionError(f"cluster_info misses a fleet: {info}")
    rep["info_schema"] = {"dcn_worker_stats": stats, "cluster_info": info}
    rep["memory_end"] = dcn_device_memory(torch, procs)
    log(f"dcn information_schema.dcn_worker_stats: {stats}; cluster_info: {info}")


# -- workloads: SSB's 13 queries and TPC-DS Q95 -------------------------------

WORKLOAD_SEED = 7
SSB_SF = 1.0      # 1,500,000 orders, about 6M lineorder rows
Q95_SF = 10.0     # the generator's sf: 600,000 orders, about 1.5M web_sales rows
WORKLOAD_WARM = 1

# per SSB query: the fact filter, each dimension's filter (by prefix: d_
# date, c_ customer, s_ supplier, p_ part), the SELECT list ("@" is the
# sum), the summed value (scaled int64) and the ORDER BY (name, desc)
SSB_SPECS = {
    "q1.1": dict(fact=lambda F: (F["lo_discount"] >= 1) & (F["lo_discount"] <= 3)
                 & (F["lo_quantity"] < 25),
                 dims={"d": lambda D: D["d_year"] == 1993},
                 select=["@"], value=lambda F: F["lo_extendedprice"] * F["lo_discount"],
                 order=[]),
    "q1.2": dict(fact=lambda F: (F["lo_discount"] >= 4) & (F["lo_discount"] <= 6)
                 & (F["lo_quantity"] >= 26) & (F["lo_quantity"] <= 35),
                 dims={"d": lambda D: D["d_yearmonthnum"] == 199401},
                 select=["@"], value=lambda F: F["lo_extendedprice"] * F["lo_discount"],
                 order=[]),
    "q1.3": dict(fact=lambda F: (F["lo_discount"] >= 5) & (F["lo_discount"] <= 7)
                 & (F["lo_quantity"] >= 26) & (F["lo_quantity"] <= 35),
                 dims={"d": lambda D: (D["d_weeknuminyear"] == 6) & (D["d_year"] == 1994)},
                 select=["@"], value=lambda F: F["lo_extendedprice"] * F["lo_discount"],
                 order=[]),
    "q2.1": dict(dims={"p": lambda D: D["p_category"] == "MFGR#12",
                       "s": lambda D: D["s_region"] == "AMERICA"},
                 select=["@", "d_year", "p_brand1"], value=lambda F: F["lo_revenue"],
                 order=[("d_year", False), ("p_brand1", False)]),
    "q2.2": dict(dims={"p": lambda D: (D["p_brand1"] >= "MFGR#2221")
                       & (D["p_brand1"] <= "MFGR#2228"),
                       "s": lambda D: D["s_region"] == "ASIA"},
                 select=["@", "d_year", "p_brand1"], value=lambda F: F["lo_revenue"],
                 order=[("d_year", False), ("p_brand1", False)]),
    "q2.3": dict(dims={"p": lambda D: D["p_brand1"] == "MFGR#2239",
                       "s": lambda D: D["s_region"] == "EUROPE"},
                 select=["@", "d_year", "p_brand1"], value=lambda F: F["lo_revenue"],
                 order=[("d_year", False), ("p_brand1", False)]),
    "q3.1": dict(dims={"c": lambda D: D["c_region"] == "ASIA",
                       "s": lambda D: D["s_region"] == "ASIA",
                       "d": lambda D: (D["d_year"] >= 1992) & (D["d_year"] <= 1997)},
                 select=["c_nation", "s_nation", "d_year", "@"],
                 value=lambda F: F["lo_revenue"], order=[("d_year", False), ("@", True)]),
    "q3.2": dict(dims={"c": lambda D: D["c_nation"] == "UNITED STATES",
                       "s": lambda D: D["s_nation"] == "UNITED STATES",
                       "d": lambda D: (D["d_year"] >= 1992) & (D["d_year"] <= 1997)},
                 select=["c_city", "s_city", "d_year", "@"],
                 value=lambda F: F["lo_revenue"], order=[("d_year", False), ("@", True)]),
    "q3.3": dict(dims={"c": lambda D: (D["c_city"] == "UNITED KI1")
                       | (D["c_city"] == "UNITED KI5"),
                       "s": lambda D: (D["s_city"] == "UNITED KI1")
                       | (D["s_city"] == "UNITED KI5"),
                       "d": lambda D: (D["d_year"] >= 1992) & (D["d_year"] <= 1997)},
                 select=["c_city", "s_city", "d_year", "@"],
                 value=lambda F: F["lo_revenue"], order=[("d_year", False), ("@", True)]),
    "q3.4": dict(dims={"c": lambda D: (D["c_city"] == "UNITED KI1")
                       | (D["c_city"] == "UNITED KI5"),
                       "s": lambda D: (D["s_city"] == "UNITED KI1")
                       | (D["s_city"] == "UNITED KI5"),
                       "d": lambda D: D["d_yearmonth"] == "Dec1997"},
                 select=["c_city", "s_city", "d_year", "@"],
                 value=lambda F: F["lo_revenue"], order=[("d_year", False), ("@", True)]),
    "q4.1": dict(dims={"c": lambda D: D["c_region"] == "AMERICA",
                       "s": lambda D: D["s_region"] == "AMERICA",
                       "p": lambda D: (D["p_mfgr"] == "MFGR#1") | (D["p_mfgr"] == "MFGR#2")},
                 select=["d_year", "c_nation", "@"],
                 value=lambda F: F["lo_revenue"] - F["lo_supplycost"],
                 order=[("d_year", False), ("c_nation", False)]),
    "q4.2": dict(dims={"c": lambda D: D["c_region"] == "AMERICA",
                       "s": lambda D: D["s_region"] == "AMERICA",
                       "d": lambda D: (D["d_year"] == 1997) | (D["d_year"] == 1998),
                       "p": lambda D: (D["p_mfgr"] == "MFGR#1") | (D["p_mfgr"] == "MFGR#2")},
                 select=["d_year", "s_nation", "p_category", "@"],
                 value=lambda F: F["lo_revenue"] - F["lo_supplycost"],
                 order=[("d_year", False), ("s_nation", False), ("p_category", False)]),
    "q4.3": dict(dims={"s": lambda D: D["s_nation"] == "UNITED STATES",
                       "d": lambda D: (D["d_year"] == 1997) | (D["d_year"] == 1998),
                       "p": lambda D: D["p_category"] == "MFGR#14"},
                 select=["d_year", "s_city", "p_brand1", "@"],
                 value=lambda F: F["lo_revenue"] - F["lo_supplycost"],
                 order=[("d_year", False), ("s_city", False), ("p_brand1", False)]),
}
SSB_DIMS = {"d": ("ssb_date", "d_datekey", "lo_orderdate"),
            "c": ("ssb_customer", "c_custkey", "lo_custkey"),
            "s": ("ssb_supplier", "s_suppkey", "lo_suppkey"),
            "p": ("ssb_part", "p_partkey", "lo_partkey")}


class _DimView:
    """A dimension table's columns by name, strings decoded (a dimension
    is small: at most 200,000 rows at SF1)."""

    def __init__(self, np, t):
        self.np, self.t, self.cache = np, t, {}

    def __getitem__(self, name):
        got = self.cache.get(name)
        if got is None:
            a = self.t.data[name][:self.t.n]
            if name in self.t.dicts:
                a = self.np.asarray(self.t.dicts[name].values)[a]
            got = self.cache[name] = a
        return got


def numpy_ssb(np, cat) -> dict:
    """Each SSB query's rows by numpy over the generated arrays: the sum
    a scaled int64 (exact), the rows in the query's ORDER BY (ties in
    generation order)."""
    lo = cat.table("test", "lineorder")
    n = lo.n
    F = {c: lo.data[c][:n] for c in ("lo_orderdate", "lo_custkey", "lo_suppkey",
                                     "lo_partkey", "lo_quantity", "lo_discount")}
    dims, pos = {}, {}
    for p, (tname, key, fk) in SSB_DIMS.items():
        dims[p] = _DimView(np, cat.table("test", tname))
        keys = dims[p][key]
        order = np.argsort(keys, kind="stable")
        at = np.searchsorted(keys[order], lo.data[fk][:n])
        if not (keys[order][np.minimum(at, len(keys) - 1)] == lo.data[fk][:n]).all():
            raise AssertionError(f"ssb: a lineorder {fk} has no {tname} row")
        pos[p] = order[at]
    out = {}
    for q, spec in SSB_SPECS.items():
        m = spec["fact"](F) if "fact" in spec else np.ones(n, dtype=bool)
        for p, pred in spec["dims"].items():
            m &= pred(dims[p])[pos[p]]
        rows = np.nonzero(m)[0]
        vals_f = {c: lo.data[c][:n][rows] for c in ("lo_extendedprice", "lo_discount",
                                                   "lo_revenue", "lo_supplycost")}
        vals = spec["value"](vals_f).astype(np.int64)
        keys = [c for c in spec["select"] if c != "@"]
        if not keys:
            out[q] = [tuple(int(vals.sum()) if c == "@" else None for c in spec["select"])]
            continue
        cols = [dims[c[0]][c][pos[c[0]][rows]] for c in keys]
        groups = {}
        for i, k in enumerate(zip(*(a.tolist() for a in cols))):
            groups.setdefault(k, []).append(i)
        res = []
        for k, idx in groups.items():
            named = dict(zip(keys, k))
            named["@"] = int(vals[np.asarray(idx)].sum())
            res.append(tuple(named[c] for c in spec["select"]))
        out[q] = ssb_sorted(res, spec)
    return out


def ssb_order_key(row, spec):
    sel = spec["select"]
    return tuple(-row[sel.index(c)] if desc else row[sel.index(c)]
                 for c, desc in spec["order"])


def ssb_sorted(rows, spec):
    return sorted(rows, key=lambda r: ssb_order_key(r, spec))


def check_ssb_rows(q, got, want, spec):
    """The port's rows (the sum a decimal string) against numpy's: equal as
    a multiset, and in the ORDER BY's order (rows that tie on its keys in
    any order)."""
    agg = spec["select"].index("@")
    g = [tuple(_scaled(v) if i == agg else v for i, v in enumerate(r)) for r in got]
    if len(g) != len(want) or sorted(g, key=repr) != sorted(want, key=repr):
        raise AssertionError(f"ssb {q}: {len(g)} rows {g[:3]} vs numpy {len(want)} "
                             f"{want[:3]}")
    if [ssb_order_key(r, spec) for r in g] != [ssb_order_key(r, spec) for r in want]:
        raise AssertionError(f"ssb {q}: rows out of the ORDER BY's order: {g[:5]}")


def numpy_q95(np, cat) -> list:
    """TPC-DS Q95 by numpy: the order numbers shipped from more than one
    warehouse (ws_wh's self-join), those also returned (the second IN
    subquery), the date, state and company filters; count distinct and
    the two sums exact."""
    ws = cat.table("test", "web_sales")
    n = ws.n
    on, wh, ship, addr, site, cost, profit = (ws.data[c][:n] for c in (
        "ws_order_number", "ws_warehouse_sk", "ws_ship_date_sk", "ws_ship_addr_sk",
        "ws_web_site_sk", "ws_ext_ship_cost", "ws_net_profit"))
    pairs = np.unique(np.stack([on, wh]), axis=1)
    u, cnt = np.unique(pairs[0], return_counts=True)
    ws_wh = u[cnt > 1]
    wr = cat.table("test", "web_returns")
    returned = np.intersect1d(wr.data["wr_order_number"][:wr.n], ws_wh)
    dd = _DimView(np, cat.table("test", "date_dim"))
    days = dd["d_date"]
    d_ok = dd["d_date_sk"][(days >= _days(np, "1999-02-01")) & (days <= _days(np, "1999-04-02"))]
    ca = _DimView(np, cat.table("test", "customer_address"))
    a_ok = ca["ca_address_sk"][ca["ca_state"] == "IL"]
    wsite = _DimView(np, cat.table("test", "web_site"))
    s_ok = wsite["web_site_sk"][wsite["web_company_name"] == "pri"]
    m = (np.isin(ship, d_ok) & np.isin(addr, a_ok) & np.isin(site, s_ok)
         & np.isin(on, ws_wh) & np.isin(on, returned))
    if not m.any():
        return [(0, None, None)]
    return [(int(len(np.unique(on[m]))), int(cost[m].astype(np.int64).sum()),
             int(profit[m].astype(np.int64).sum()))]


# Q95's CTE ws_wh is materialized while the statement is planned: its
# self-join, whose every consumer is an IN subquery, is rewritten to a
# grouped min/max distinctness test over web_sales, one fused generic
# aggregation that the physical plan (which scans the result) does not show
Q95_CTE_FRAGMENTS = {"generic": 1}


def workload_runs(s, mods, sql, agg_chunks, label, extra=None) -> dict:
    """One cold run and WORKLOAD_WARM warm runs of `sql`, each with the
    plan taken just before it, its fused fragments and its launches
    (run_query), and held to the plan's launch contract (check_path) with
    the fragments `extra` adds to the plan's."""
    from tidb_tpu_torch.planner.physical import explain_text

    runs = []
    for i in range(1 + WORKLOAD_WARM):
        plan = planned(s, sql)
        want = plan_fragments(plan, s._plan_capacity(plan))
        for k, v in (extra or {}).items():
            want[k] += v
        agg_chunks[0] = 0
        rows, cnt, dt = run_query(s, mods, sql)
        check_path(label, cnt, agg_chunks[0], want)
        runs.append({"s": dt, "rows": rows, "plan": plan_shape(explain_text(plan)),
                     "fragments": want, "fused": cnt["fused"],
                     "launches": {k: v for k, v in cnt["launches"].items() if v},
                     "routes": {k: v for k, v in cnt["routes"].items() if v},
                     "aggregated_chunks": agg_chunks[0], "device_get": cnt["device_get"]})
    if any(r["rows"] != runs[0]["rows"] for r in runs[1:]):
        raise AssertionError(f"{label}: a warm run's rows differ from the cold run's")
    warm = [r["s"] for r in runs[1:]]
    return {"cold_s": runs[0]["s"], "warm_s": warm, "warm_median_s": statistics.median(warm),
            "rows": runs[0]["rows"], "runs": [{k: v for k, v in r.items() if k != "rows"}
                                              for r in runs]}


def phase_workloads(torch, np, Session, mods, ssb_sf: float = SSB_SF,
                    q95_sf: float = Q95_SF, device=None, rec=None) -> dict:
    """SSB's 13 queries at `ssb_sf` and TPC-DS Q95 at the generator's
    `q95_sf` on a fresh Session (seed WORKLOAD_SEED), each against numpy
    over the same generated arrays: one cold run and a warm median of
    WORKLOAD_WARM, each run held to its plan's launch contract. Returns
    the report: each table's ingest seconds and each workload's load
    seconds (generation included), the device bytes held after the first
    SSB query, each query's runs and the phase's launches ("launches"). With
    `rec` (record_probe_chunks) each query's probe calls are recorded
    under its name."""
    from tidb_tpu_torch.storage.ssb import SSB_QUERIES, load_ssb
    from tidb_tpu_torch.storage.tpcds import Q95, load_tpcds_q95

    t_phase = time.perf_counter()
    seg_mod, hp, jk, pl, st, agg_mod = mods
    s = Session(device=device)
    cat = s.catalog.base
    rep = {"card": card_line(), "ssb_sf": ssb_sf, "q95_sf": q95_sf, "load_s": {}}
    from tidb_tpu_torch.storage.table import Table

    real_insert = Table.insert_columns

    def timed_insert(self, *a, **kw):
        # each table's ingest (the generator makes its arrays before)
        t1 = time.perf_counter()
        try:
            return real_insert(self, *a, **kw)
        finally:
            rep["load_s"][self.schema.name] = {"rows": self.n,
                                               "ingest_s": time.perf_counter() - t1}

    Table.insert_columns = timed_insert
    try:
        for name, load, sf in (("ssb", load_ssb, ssb_sf),
                               ("tpcds_q95", load_tpcds_q95, q95_sf)):
            t0 = time.perf_counter()
            counts = load(cat, sf=sf, seed=WORKLOAD_SEED)
            rep["load_s"][name] = {"s": time.perf_counter() - t0}
            log(f"workloads: {name} at sf {sf} generated and loaded in "
                f"{rep['load_s'][name]['s']:.1f} s: {counts}")
    finally:
        Table.insert_columns = real_insert
    # the first query of each table folds it into segments; the device
    # bytes held after the load are those of the first SSB and Q95 runs
    agg_chunks = count_segment_chunks()
    want_ssb = numpy_ssb(np, cat)
    want_q95 = numpy_q95(np, cat)
    queries = rep["queries"] = {}
    launches = rep["launches"] = {}
    for q, sql in list(SSB_QUERIES.items()) + [("q95", Q95)]:
        if rec is not None:
            rec["query"] = q
        r = workload_runs(s, mods, sql, agg_chunks, f"workloads {q}",
                          Q95_CTE_FRAGMENTS if q == "q95" else None)
        if q == "q95":
            got = [(c, None if a is None else _scaled(a), None if b is None else _scaled(b))
                   for c, a, b in r["rows"]]
            if got != want_q95:
                raise AssertionError(f"q95: {r['rows']} vs numpy {want_q95}")
        else:
            check_ssb_rows(q, r["rows"], want_ssb[q], SSB_SPECS[q])
        for run in r["runs"]:
            for k, v in run["launches"].items():
                launches[k] = launches.get(k, 0) + v
        queries[q] = {k: v for k, v in r.items() if k != "rows"}
        queries[q]["n_rows"] = len(r["rows"])
        first = r["runs"][0]
        log(f"workloads {q}: {len(r['rows'])} rows equal numpy; cold {r['cold_s'] * 1e3:.3f} "
            f"ms, warm median {r['warm_median_s'] * 1e3:.3f} ms "
            f"{[round(x * 1e3, 3) for x in r['warm_s']]}; fused {first['fused']}, launches "
            f"{first['launches']}, routes {first['routes']}, device_get {first['device_get']}")
        if q == "q1.1" and device is None:
            torch.cuda.synchronize()
            rep["device_bytes_after_load"] = torch.cuda.memory_allocated()
    if device is None:
        rep["device_bytes_end"] = torch.cuda.memory_allocated()
    if not launches.get("segagg") or not launches.get("probe_count"):
        if device is None:
            raise AssertionError(f"workloads: a kernel never launched: {launches}")
    rep["s"] = time.perf_counter() - t_phase
    log(f"workloads phase passed in {rep['s']:.1f} s; launches {launches}")
    del s
    pl.DEVICE_CACHE.clear()
    return rep


# -- the sanitized step: the runtime sanitizer on the SF1 session --------------

SANITIZED_QUERIES = ("q1", "q6", "q3", "q5", "q18")


def phase_sanitized(torch, np, s, mods, results) -> dict:
    """SET tidb_tpu_sanitize = 1 on the SF1 session, then Q1, Q6, Q3, Q5
    and Q18 once each: rows equal to phase 2's (which equal numpy), no
    SanitizerError; per statement the sanctioned device_get round trips
    (dispatch.fetch_count), the lock-order edges witnessed, the non-fatal
    findings and the runtime edges the static lock graph lacks. Then a Q6
    whose scan pins are never closed must raise SanitizerError (pin-leak);
    the pins are closed afterwards and the sanitizer disabled."""
    from tidb_tpu_torch.analysis import sanitizer as san
    from tidb_tpu_torch.analysis.lock_discipline import static_lock_edges
    from tidb_tpu_torch.errors import SanitizerError
    from tidb_tpu_torch.storage.tpch_queries import Q
    from tidb_tpu_torch.utils import dispatch

    seg_mod, hp, jk, pl, st, agg_mod = mods
    t_phase = time.perf_counter()
    static = static_lock_edges(os.path.dirname(os.path.abspath(__file__)))
    san.disable()
    rep = {"card": card_line(), "statements": {}}
    s.execute("set tidb_tpu_sanitize = 1")
    try:
        for q in SANITIZED_QUERIES:
            e0 = san.lock_edges()
            n0 = len(san.report()["findings"])
            f0 = dispatch.fetch_count()
            t0 = time.perf_counter()
            rows = s.query(Q[q][0])  # a SanitizerError fails the phase
            dt = time.perf_counter() - t0
            syncs = dispatch.fetch_count() - f0
            if rows != results[q]:
                raise AssertionError(f"sanitized {q}: rows differ from phase 2's")
            edges = san.lock_edges()
            new = sorted((a, b) for a, bs in edges.items() for b in bs
                         if b not in e0.get(a, {}))
            notes = [f for f in san.report()["findings"][n0:]]
            if any(f["fatal"] for f in notes):
                raise AssertionError(f"sanitized {q}: fatal findings {notes}")
            novel = sorted((a, b) for a, bs in edges.items() for b in bs
                           if b not in static.get(a, {}))
            rep["statements"][q] = {"s": dt, "device_get": syncs, "new_edges": new,
                                    "notes": notes, "novel_edges": novel}
            log(f"sanitized {q}: rows equal phase 2's in {dt * 1e3:.3f} ms; "
                f"{syncs} device_get round trips; lock edges witnessed {new}; "
                f"non-fatal findings {[(f['kind'], f['subject']) for f in notes]}; "
                f"runtime-only edges (diff_static) {novel}")
        # a leaked pin under a sanitized statement on the card
        leaked = []
        real_close = st.ScanPin.close

        def leak(self):
            leaked.append(self)

        st.ScanPin.close = leak
        pl.DEVICE_CACHE.clear()  # Q6 stages from the store: its scan pins
        try:
            s.query(Q["q6"][0])
            raise AssertionError("sanitized q6 with its scan pins never closed "
                                 "raised no SanitizerError")
        except SanitizerError as e:
            if "pin-leak" not in str(e):
                raise
            rep["leaked_pin_error"] = str(e)[:300]
        finally:
            st.ScanPin.close = real_close
            for pin in leaked:
                pin.close()
        rep["leaked_pins"] = len(leaked)
        log(f"sanitized q6 with {len(leaked)} scan pins never closed: SanitizerError "
            f"({rep['leaked_pin_error'][:160]})")
    finally:
        s.execute("set tidb_tpu_sanitize = 0")
        san.disable()
    rep["s"] = time.perf_counter() - t_phase
    log(f"sanitized step passed in {rep['s']:.1f} s")
    return rep


# ---------------------------------------------------------------------------
# SF10: the scale of the reference's SF10 rehearsal (SF10_REHEARSAL.json)
# ---------------------------------------------------------------------------

SF10 = 10.0
SF10_LINEITEM = 60_001_162     # the reference rehearsal's lineitem rows
# Q1, Q6 and Q5 first on a fresh session: the order that filled the card
# at SF1 before the join estimate and the probe's expansion were repaired
SF10_QUERIES = ("q1", "q6", "q5", "q3", "q18")
SF10_WARM_MAX = 3              # warm runs of a query until one captures nothing
# the session's tidb_mem_quota_query: the 2 GiB default stops Q18 at SF10
# (its builds and device group tables hold 2.4 GB); the quota step below
# runs under the rehearsal's budget instead
SF10_QUOTA = 32 << 30


def host_memory() -> dict:
    """The host's MemTotal and this process's peak RSS, in bytes."""
    import resource

    total = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
    except OSError:
        pass
    return {"mem_total": total,
            "peak_rss": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}


def sf10_reference(np, cat, q: str):
    """numpy's answer to `q` over the catalog's arrays, and its check."""
    li = cat.table("test", "lineitem")
    if q == "q1":
        want = numpy_q1(np, li)
        return lambda rows: check_q1(np, rows, want)
    if q == "q6":
        want = numpy_q6(np, li)

        def check(rows):
            if len(rows) != 1 or _scaled(rows[0][0]) != want:
                raise AssertionError(f"SF10 Q6 {rows} vs numpy {want}")
        return check
    if q == "q18":
        want = numpy_q18(np, cat)[0]
        return lambda rows: check_join_rows("q18", rows, want, {4, 5})
    want = (numpy_q3 if q == "q3" else numpy_q5)(np, cat)
    return lambda rows: check_join_rows(q, rows, want, {1})


def sf10_run(torch, s, mods, agg_chunks, q: str, label: str) -> dict:
    """One run of `q` on the SF10 session, held to the launch contract of
    the plan it ran (taken from the session as it ran: planning once more
    reads every table's live rows again, seconds at SF10); its rows,
    counts and card memory."""
    from tidb_tpu_torch.storage.tpch_queries import Q

    agg_chunks[0] = 0
    torch.cuda.reset_peak_memory_stats()
    with plans_run(s) as ran:
        rows, cnt, dt = run_query(s, mods, Q[q][0])
    plan = ran[-1]
    want = plan_fragments(plan, s._plan_capacity(plan))
    cnt["aggregated_chunks"] = agg_chunks[0]
    check_path(f"sf10 {label}", cnt, agg_chunks[0], want)
    run = {"s": dt, "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "staged_bytes": cnt["h2d"].get("h2d", 0),
           "staged_batches": cnt["staged_batches"],
           "segagg": cnt["launches"]["segagg"],
           "probe_count": cnt["launches"]["probe_count"],
           "fetches": cnt["device_get"], "segments": cnt["segments"],
           "captures": sum(v.get("capture", 0) for v in cnt["programs"].values()),
           "programs": cnt["programs"]}
    log(f"sf10 {label}: {dt:.3f} s; max_memory_allocated {run['max_memory_allocated']}; "
        f"staged {run['staged_bytes']} B in {run['staged_batches']} batches; segagg "
        f"{run['segagg']}, probe_count {run['probe_count']}; device_get {run['fetches']}; "
        f"segments {cnt['segments']}; captures {run['captures']}; programs "
        f"{cnt['programs']}")
    return {"rows": rows, "run": run}


def phase_sf10(torch, np, mods, sf: float = SF10, device=None) -> dict:
    """TPC-H at SF10 on one card, on a fresh Session (the module
    docstring's SF10 item). Every step fails the run on a wrong answer."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from tidb_tpu_torch.parallel import executor as pex
    from tidb_tpu_torch.parallel import make_mesh
    from tidb_tpu_torch.parallel.partition import table_bytes
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.table import Table
    from tidb_tpu_torch.storage.tpch import load_tpch
    from tidb_tpu_torch.storage.tpch_queries import Q
    from tidb_tpu_torch.utils import dispatch, jitcache
    from tidb_tpu_torch.utils.metrics import FRAGMENT_DISPATCH

    t_phase = time.perf_counter()
    rep = {"card": card_line(), "sf": sf, "queries": {},
           "allocated_at_start": torch.cuda.memory_allocated()}
    s = Session(device=device)
    s.execute(f"set tidb_mem_quota_query = {SF10_QUOTA}")

    # -- the load: generation and ingest per table, the primary-key checks
    timings, pk = {}, {"s": 0.0}
    real_check = Table._enforce_unique_new

    def timed_check(self, *args, **kw):
        t1 = time.perf_counter()
        try:
            return real_check(self, *args, **kw)
        finally:
            pk["s"] += time.perf_counter() - t1
            pk[self.schema.name] = pk.get(self.schema.name, 0.0) + time.perf_counter() - t1

    Table._enforce_unique_new = timed_check
    t0 = time.perf_counter()
    try:
        counts = load_tpch(s.catalog, sf=sf, db=s.db, timings=timings)
    finally:
        Table._enforce_unique_new = real_check
    rep["load"] = {"s": time.perf_counter() - t0, "counts": counts, "tables": timings,
                   "pk_check_s": pk, **host_memory()}
    if sf == SF10 and counts["lineitem"] != SF10_LINEITEM:
        raise AssertionError(f"SF10 lineitem has {counts['lineitem']} rows, the "
                             f"reference rehearsal {SF10_LINEITEM}")
    li = s.catalog.table("test", "lineitem")
    t0 = time.perf_counter()
    live = li.live_rows
    rep["live_rows_s"] = time.perf_counter() - t0
    log(f"sf10 load: {rep['load']['s']:.1f} s for {counts}; per table (gen_s, ingest_s) "
        f"{ {k: (round(v.get('gen_s', 0.0), 3), round(v['ingest_s'], 3)) for k, v in timings.items()} }; "
        f"primary-key checks {pk}; MemTotal {rep['load']['mem_total']} B, peak RSS "
        f"{rep['load']['peak_rss']} B; lineitem.live_rows ({live} rows) "
        f"{rep['live_rows_s'] * 1e3:.1f} ms of host time a call")

    agg_chunks = count_segment_chunks()
    probes = record_probe_chunks(mods[1])
    checks = {}
    refs = ThreadPoolExecutor(max_workers=1)
    try:
        # -- cold: Q1, Q6 and Q5 first, then Q3 and Q18 ----------------------
        for q in SF10_QUERIES:
            got = sf10_run(torch, s, mods, agg_chunks, q, f"{q} cold")
            rep["queries"][q] = {"cold": got["run"], "rows": got["rows"], "warm": []}
        rep["after_cold"] = {"cluster": {"clustered_rows": li.clustered_rows, "n": li.n}}
        # numpy's answers on a thread of their own while the warm runs go:
        # no statement moves a row from here on (the CLUSTER BY re-sort
        # ran at the end of the first cold run)
        t_refs = time.perf_counter()
        futures = {q: refs.submit(sf10_reference, np, s.catalog, q) for q in SF10_QUERIES}
        # -- warm: until a run captures no graph ------------------------------
        for q in SF10_QUERIES:
            for i in range(SF10_WARM_MAX):
                got = sf10_run(torch, s, mods, agg_chunks, q, f"{q} warm {i + 1}")
                if got["rows"] != rep["queries"][q]["rows"]:
                    raise AssertionError(f"sf10 {q}: a warm run's rows differ from the cold run's")
                rep["queries"][q]["warm"].append(got["run"])
                if not got["run"]["captures"]:
                    break
            else:
                raise AssertionError(f"sf10 {q}: every warm run captured a graph")
        for q in SF10_QUERIES:
            checks[q] = futures[q].result()
            checks[q](rep["queries"][q]["rows"])
        rep["numpy_s"] = time.perf_counter() - t_refs
        log(f"sf10: Q1, Q6, Q5, Q3 and Q18 equal numpy (numpy's answers {rep['numpy_s']:.1f} s "
            f"after the cold runs, beside the warm runs)")
        rep["graph_bytes"] = jitcache.graph_bytes()
        rep["graph_resident_bytes"] = jitcache.resident_bytes()
        rep["graph_quota"] = jitcache.max_bytes()
        if rep["graph_resident_bytes"] > rep["graph_quota"]:
            raise AssertionError(f"sf10 graphs hold {rep['graph_resident_bytes']} B past "
                                 f"the quota {rep['graph_quota']}")
        log(f"sf10 graphs: {rep['graph_resident_bytes']} B held (quota "
            f"{rep['graph_quota']}), per namespace {rep['graph_bytes']}")
        if not li.clustered_rows == li.n:
            raise AssertionError("sf10: lineitem was not re-sorted by its CLUSTER BY column")
        q6_seg = rep["queries"]["q6"]["warm"][-1]["segments"]
        if not q6_seg.get("pruned"):
            raise AssertionError(f"sf10 Q6 pruned no segment: {q6_seg}")

        # -- Q18 under a quarter of lineitem's column bytes ---------------------
        quota = table_bytes(li) // 4
        rep["q18_quota"] = {"quota_bytes": quota, "lineitem_bytes": table_bytes(li)}
        spill_dir = os.path.abspath(os.path.join("build", "sf10_spill"))
        os.makedirs(spill_dir, exist_ok=True)
        saved_tmp = tempfile.tempdir
        tempfile.tempdir = spill_dir
        s.execute("set tidb_device_engine_mode = 'off'")
        try:
            step = []
            sql = Q["q18"][0].replace(
                "select", f"select /*+ MEMORY_QUOTA({quota // (1 << 20)} MB) */", 1)
            rows, rec = planner_step(s, mods, sql, "sf10 q18 engine off under quota", step,
                                     check=checks["q18"])
            if rows != rep["queries"]["q18"]["rows"]:
                raise AssertionError("sf10 Q18 under the quota: rows differ from the resident run")
            if rec["spill_bytes"] <= 0:
                raise AssertionError(f"sf10 Q18 under {quota} B spilled nothing: {rec}")
            left = [n for n in os.listdir(spill_dir) if n.startswith("tidb_tpu_spill_")]
            if left:
                raise AssertionError(f"sf10: spill files left behind: {left}")
            rep["q18_quota"].update(rec)
        finally:
            tempfile.tempdir = saved_tmp
            s.execute("set tidb_device_engine_mode = 'auto'")
        log(f"sf10 q18 under {quota} B (a quarter of lineitem's {table_bytes(li)} B): "
            f"{rep['q18_quota']['s']:.1f} s, {rep['q18_quota']['spill_bytes']} B spilled, "
            f"rows identical to the resident run, every tracker at 0, no spill file left")
    finally:
        stop_recording(probes)
        refs.shutdown(wait=True, cancel_futures=True)
    rep["probe_modes"] = recorded_modes(probes)

    # -- Q6 on a mesh of the one card: resident, then streamed ---------------
    seg_mod = mods[0]
    mesh_segagg = 0
    mesh = make_mesh(devices=None if device is None else [device])
    sm = Session(s.catalog.base, mesh=mesh)
    want6 = rep["queries"]["q6"]["rows"]
    rep["mesh_q6"] = {}
    li_bytes = table_bytes(li)
    try:
        for label, budget in (("resident", None), ("streamed", li_bytes // 4)):
            if budget is not None:
                sm.execute(f"set tidb_device_cache_bytes = {budget}")
            # the programs' warm-up, capture and replay: a streamed run's
            # batches warm up, capture and replay within the first run
            runs = []
            for _ in range(3 if budget is None else 2):
                before = FRAGMENT_DISPATCH.value(kind="scan_agg_stream")
                seg_mod.reset_launches()
                jitcache.reset_runs()
                t0 = time.perf_counter()
                rows = sm.query(Q["q6"][0])
                dt = time.perf_counter() - t0
                batches = FRAGMENT_DISPATCH.value(kind="scan_agg_stream") - before
                mesh_segagg += seg_mod.LAUNCHES["segagg"]
                if rows != want6:
                    raise AssertionError(f"sf10 mesh Q6 ({label}): {rows} vs the single "
                                         f"card's {want6}")
                if (budget is None) != (batches == 0) or (budget is not None and batches < 2):
                    raise AssertionError(f"sf10 mesh Q6 ({label}): {batches} streamed batches")
                if not seg_mod.LAUNCHES["segagg"]:
                    raise AssertionError(f"sf10 mesh Q6 ({label}) launched no tidb_segagg")
                runs.append({"s": dt, "segagg": seg_mod.LAUNCHES["segagg"],
                             "programs": jitcache.runs()})
            last = runs[-1]["programs"]
            if not last.get("distagg") or any(set(r) != {"replay"} for r in last.values()):
                raise AssertionError(f"sf10 mesh Q6 ({label}): the last run ran {last}")
            held = jitcache.resident_bytes()
            mesh_bytes = {ns: sum(v) for ns, v in jitcache.graph_bytes().items()
                          if ns in MESH_NS}
            # the resident sharding is read in place: no second copy of it
            if held > jitcache.max_bytes() or sum(mesh_bytes.values()) >= li_bytes // 2:
                raise AssertionError(f"sf10 mesh Q6 ({label}): graphs hold {held} B (mesh "
                                     f"{mesh_bytes}), lineitem {li_bytes} B, quota "
                                     f"{jitcache.max_bytes()}")
            rep["mesh_q6"][label] = {"s": runs[0]["s"], "runs": runs, "batches": batches,
                                     "budget": budget, "segagg": runs[0]["segagg"],
                                     "graph_bytes": mesh_bytes, "graph_resident_bytes": held,
                                     "classes": mesh_classes(sm, Q["q6"][0])}
            log(f"sf10 mesh q6 {label}: {[round(r['s'], 4) for r in runs]} s (warm-up, "
                f"capture, replay; streamed: within the first), {batches} streamed batches, "
                f"tidb_segagg "
                f"{runs[0]['segagg']} a run, rows equal the single card's; programs "
                f"{[r['programs'] for r in runs]}; mesh graph bytes {mesh_bytes} of "
                f"{held} B held (lineitem {li_bytes} B, quota {jitcache.max_bytes()})")
    finally:
        sm._shard_cache.clear_tables()
    rep["mesh_segagg"] = mesh_segagg
    rep["fallbacks"] = dict(pex.FALLBACKS)
    rep["launches"] = {
        "segagg": sum(r["segagg"] for v in rep["queries"].values()
                      for r in [v["cold"], *v["warm"]]) + rep["q18_quota"]["launches"]["segagg"],
        "probe_count": sum(rep["probe_modes"].values())}
    for v in rep["queries"].values():
        v["rows"] = len(v["rows"])
    del s, sm, li
    pl = mods[3]
    pl.DEVICE_CACHE.clear()
    jitcache.clear()
    torch.cuda.empty_cache()
    rep["s"] = time.perf_counter() - t_phase
    log(f"sf10 phase passed in {rep['s']:.1f} s; launches {rep['launches']}, mesh tidb_segagg "
        f"{mesh_segagg}; probe_count by route and mode {rep['probe_modes']}; device_get by "
        f"query {[(q, v['warm'][-1]['fetches']) for q, v in rep['queries'].items()]}")
    return rep


def sf10_row_launches(rows: list, sf10: dict) -> None:
    """Set each kernels-line row's launches_sf10: the SF10 phase's
    single-card launches on the rows at the main path's shapes
    (tidb_probe_count's on the row of its route and mode), its one-card
    mesh's tidb_segagg on segagg.mesh, the other rows at 0. Fails if a
    launch of the phase has no row to sit on."""
    modes = sf10["probe_modes"]
    placed = {"segagg": 0, "probe_count": 0, "mesh": 0}
    for row in rows:
        name = row["name"]
        if name.startswith("probe_count."):
            row["launches_sf10"] = modes.get(PROBE_ROW_MODES.get(name), 0)
            placed["probe_count"] += row["launches_sf10"]
        elif name == "segagg":
            row["launches_sf10"] = placed["segagg"] = sf10["launches"]["segagg"]
        elif name == "segagg.mesh":
            row["launches_sf10"] = placed["mesh"] = sf10["mesh_segagg"]
        else:
            row["launches_sf10"] = 0
    want = {"segagg": sf10["launches"]["segagg"], "probe_count": sum(modes.values()),
            "mesh": sf10["mesh_segagg"]}
    if placed != want:
        raise AssertionError(f"sf10 launches with no kernels-line row: placed {placed}, "
                             f"launched {want}; probe modes {modes}")


def sf1_phases(torch, np, mods, card: str, name: str, sass: dict) -> tuple:
    """Every phase before SF10 (phase 1 through the DCN tier, items 1-10
    of the module docstring); returns (the kernels line's rows, the
    report). Its sessions and tensors are gone when it returns."""
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.table import Table
    from tidb_tpu_torch.storage.tpch_queries import Q

    seg_mod, hp, jk, pl, st, agg_mod = mods
    # -- phase 1 ------------------------------------------------------------
    errs = phase_kernels(torch, np, seg_mod)
    segagg_checks = phase_segagg(torch, np, seg_mod)
    probe_checks = phase_probe(torch, np, hp)
    probe_count_checks = phase_probe_count(torch, np, jk, hp)

    # -- bench_segsum: the segment kernels against index_add_ ----------------
    from tidb_tpu_torch.ops import bench_segsum

    t0 = time.perf_counter()
    segsum_bench = bench_segsum.run()
    with open(os.path.join(OUT_DIR, "SEGSUM_BENCH.json"), "w") as f:
        json.dump(segsum_bench, f, indent=1)
    for c in segsum_bench["configs"]:
        log(f"bench_segsum {json.dumps(c)}")
    if not segsum_bench["all_exact"]:
        raise AssertionError(f"bench_segsum: an exactness flag is false: "
                             f"{segsum_bench['configs']}")
    log(f"bench_segsum: R = {segsum_bench['rows']}, G in {bench_segsum.GROUPS}, every exactness "
        f"flag true, in {time.perf_counter() - t0:.1f} s")

    # -- the grid: 22 queries at SF0.1 against sqlite ------------------------
    t0 = time.perf_counter()
    grid, grid_cat, grid_oracle = phase_grid(torch, np, Session, mods)
    pl.DEVICE_CACHE.clear()  # the grid's staged tables, off the card
    log(f"grid: all 22 queries equal sqlite in {time.perf_counter() - t0:.1f} s")

    # -- workloads: SSB's 13 queries at SF1 and TPC-DS Q95 at sf 10 ----------
    # (the probe calls are recorded: Q95's semi joins give the kernels
    # line its direct flags-only row at the main path's shape)
    wl_probes = record_probe_chunks(hp, args=True)
    try:
        workloads = phase_workloads(torch, np, Session, mods, rec=wl_probes)
    finally:
        stop_recording(wl_probes)
    workloads["probe_modes"] = recorded_modes(wl_probes)
    log(f"workloads: probe_count by route and mode {workloads['probe_modes']}")

    # -- phase 2 ------------------------------------------------------------
    s = Session()  # device=None: the card
    load = {"pk_check_s": 0.0, "pk_check_by_table": {}}
    real_check = Table._enforce_unique_new

    def timed_check(self, *args, **kw):
        # the primary-key check of every ingest, timed for the refresh phase
        t1 = time.perf_counter()
        try:
            return real_check(self, *args, **kw)
        finally:
            dt = time.perf_counter() - t1
            load["pk_check_s"] += dt
            by = load["pk_check_by_table"]
            by[self.schema.name] = by.get(self.schema.name, 0.0) + dt

    Table._enforce_unique_new = timed_check
    t0 = time.perf_counter()
    try:
        counts = s.load_tpch(1.0)
    finally:
        Table._enforce_unique_new = real_check
    load["load_s"] = time.perf_counter() - t0
    log(f"TPC-H SF1 loaded in {load['load_s']:.1f} s (primary-key checks "
        f"{load['pk_check_s']:.1f} s): {counts}")
    queries = ("q1", "q6", "q3", "q5", "q18")
    cluster = phase_cluster(np, s, mods)
    p2 = phase_paths(torch, np, s, mods, Session, queries)
    cluster["phase2"] = cluster_summary(p2["per_query"])
    li, n_rows, results, per_query = p2["li"], p2["n_rows"], p2["results"], p2["per_query"]
    cold, probes, probe_modes = p2["cold"], p2["probes"], p2["probe_modes"]
    launches, launches_classic = p2["launches"], p2["launches_classic"]
    launches_packed, classic_counts = p2["launches_packed"], p2["classic_counts"]
    packed, plans, q18_build = p2["packed"], p2["plans"], p2["q18_build"]
    q18_sub = Q["q18"][0].split("in (", 1)[1].split(")\n", 1)[0]
    sync_free = sync_free_pass(torch, s, mods, {"q3": Q["q3"][0], "q18": Q["q18"][0],
                                                "q18_subquery": q18_sub})
    topn = phase_topn(np, s, mods)
    sanitized = phase_sanitized(torch, np, s, mods, results)
    t0 = time.perf_counter()
    graphs = phase_graphs(torch, np, s, mods, results)
    graphs["s"] = time.perf_counter() - t0
    log(f"graphs phase passed in {graphs['s']:.1f} s")

    # -- phase 3 ------------------------------------------------------------
    times, profiles = phase_modes(torch, s, queries, n_rows,
                                  {q: graphs[q]["graphs"]["median_s"] for q in queries})

    # Q18's IN subquery alone (a generic aggregation of lineitem by order
    # key, fused on the device; and on the host engine): how much of Q18 is
    # not the join. Its profile's device->host copies are the finalize
    # fetch of the stack's tables alone: the slot counts, then every live slot
    # (the host engine's run of it was cut for the DCN phase's time)
    for mode in ("fused_cache",):
        runs = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            s.query(q18_sub)
            runs.append(time.perf_counter() - t0)
        times[mode]["q18_subquery"] = statistics.median(runs)
        profiles[mode]["q18_subquery"] = prof = profile_query(torch, s, q18_sub)
        s.execute("set tidb_device_engine_mode = 'auto'")
        log(f"{mode} q18's IN subquery alone, warm wall median of {WARM_RUNS}: "
            f"{times[mode]['q18_subquery'] * 1e3:.3f} ms; runs {runs}; device->host "
            f"{prof['d2h']}; host->device {prof['h2d']}")
    if profiles["fused_cache"]["q18_subquery"]["d2h"]["count"] > 2:
        raise AssertionError("q18's IN subquery copied device->host beyond its finalize "
                             f"fetch: {profiles['fused_cache']['q18_subquery']['d2h']}")
    memory = {name: peak_memory(torch, s, sql) for name, sql in
              (("q18", Q["q18"][0]), ("q18_subquery", q18_sub), ("q3", Q["q3"][0]))}
    log(f"peak device memory (bytes): {memory}")

    # Q1's chunk as the kernels see it: packed ids (returnflag code +
    # 4 x linestatus code) over the groups Q1 found, in the proportions of
    # their counts, and the share of rows its shipdate filter keeps
    q1_rows = results["q1"]
    rng = np.random.default_rng(7)
    R, G = Q1_ROWS, Q1_GROUPS
    rf_vals = li.dicts["l_returnflag"].values
    ls_vals = li.dicts["l_linestatus"].values
    gids = np.array([rf_vals.index(r[0]) + (len(rf_vals) + 1) * ls_vals.index(r[1])
                     for r in q1_rows])
    gcnt = np.array([r[9] for r in q1_rows], dtype=np.float64)
    ids = rng.choice(gids, R, p=gcnt / gcnt.sum())
    seg = torch.from_numpy(ids.astype(np.int64)).cuda()
    mask = torch.from_numpy(rng.random(R) < gcnt.sum() / n_rows).cuda()
    vals = torch.from_numpy(rng.integers(0, 1 << 32, R).astype(np.int64)).cuda()
    mask_i64 = mask.to(torch.int64)
    lib_out = torch.zeros(G, dtype=torch.int64, device="cuda")
    rows = []
    specs = [
        ("segsum_count", "tidb_tpu/ops/segment_sum.py:112", 1,
         lambda: seg_mod.segment_count(mask, seg, G),
         lambda: seg_mod.plain_segment_count(mask, seg, G),
         lambda: lib_out.index_add_(0, seg, mask_i64)),
        ("segsum_i64", "tidb_tpu/ops/segment_sum.py:177", 8,
         lambda: seg_mod.segment_sum_i64(vals, seg, G),
         lambda: seg_mod.plain_segment_sum_i64(vals, seg, G),
         lambda: lib_out.index_add_(0, seg, vals)),
    ]
    for kname, replaces, vbytes, kern, plain, library in specs:
        ms = device_ms(torch, kern, graph=True)
        plain_ms = device_ms(torch, plain, graph=False)
        library_ms = device_ms(torch, library, graph=True)
        nbytes = R * (vbytes + 8) + G * 8  # values + int64 ids in, [G] out
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = R / SCALAR_OPS_PER_S * 1e3  # one add per row
        rows.append({
            "name": kname, "route": "cuda",
            "source": "tidb_tpu_torch/ops/csrc/segment_sum.cu",
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
        })
        log(f"{kname} at R={R} G={G}: {ms * 1e3:.2f} us/call, bound "
            f"{max(bytes_ms, ops_ms) * 1e3:.3f} us ({nbytes} B), plain "
            f"{plain_ms * 1e3:.2f} us, index_add_ {library_ms * 1e3:.2f} us")

    # the fused update at Q1's chunk shape: the same ids and live rows, 7
    # decimal columns drawn like `vals` with their (all-true) validity,
    # into Q1's 16 accumulators and 23 outputs
    dvals = [torch.from_numpy(rng.integers(0, 1 << 32, R).astype(np.int64)).cuda()
             for _ in range(Q1_DECIMALS)]
    dmasks = [torch.ones(R, dtype=torch.bool, device="cuda") for _ in range(Q1_DECIMALS)]
    accs = q1_accs(torch, seg_mod, dvals, dmasks, G, "cuda")
    check_segagg_case(torch, seg_mod, seg, G, mask, accs)
    n_out = sum(2 if a.kind == "limbs" else 1 for a in accs)
    # the library yardstick's operand: each output's per-row contribution
    cols = []
    for a in accs:
        live = mask if a.mask is None else mask & a.mask
        if a.kind == "count":
            cols.append(live.to(torch.int64))
        else:
            v = torch.where(live, a.vals, 0)
            cols += [v & 0xFFFFFFFF, v >> 32]
    stacked = torch.stack(cols, 1).contiguous()
    lib23 = torch.zeros(G, n_out, dtype=torch.int64, device="cuda")
    ms = device_ms(torch, lambda: seg_mod.segment_accumulate(seg, G, mask, accs), graph=True)
    plain_ms = device_ms(torch, lambda: seg_mod.plain_segment_accumulate(seg, G, mask, accs),
                         graph=False)
    library_ms = device_ms(torch, lambda: lib23.index_add_(0, seg, stacked), graph=True)
    nbytes = R * (8 + 1 + Q1_DECIMALS * (8 + 1)) + n_out * G * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = R * n_out / SCALAR_OPS_PER_S * 1e3  # one add per row and output
    n_counts = sum(1 for a in accs if a.kind == "count")
    replaced_ms = n_counts * rows[0]["ms"] + (n_out - n_counts) * rows[1]["ms"]
    rows.append({
        "name": "segagg", "route": "cuda",
        "source": "tidb_tpu_torch/ops/csrc/segment_sum.cu",
        "replaces": "tidb_tpu/ops/segment_sum.py:177",
        "also_replaces": "tidb_tpu/ops/segment_sum.py:112",
        "launches": launches["segagg"], "max_abs_err": 0, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    })
    segagg_q1 = {"R": R, "G": G, "accumulators": len(accs), "outputs": n_out,
                 "bytes": nbytes, "replaced_calls": f"{n_counts} x segsum_count + "
                 f"{n_out - n_counts} x segsum_i64", "replaced_calls_ms": replaced_ms}
    log(f"segagg at R={R} G={G}, {len(accs)} accumulators ({n_out} outputs): "
        f"{ms * 1e3:.2f} us/call, bound {max(bytes_ms, ops_ms) * 1e3:.3f} us "
        f"({nbytes} B), plain {plain_ms * 1e3:.2f} us, index_add_ [R, {n_out}] "
        f"{library_ms * 1e3:.2f} us; the {segagg_q1['replaced_calls']} calls it "
        f"replaces take {replaced_ms * 1e3:.2f} us")

    # Q18's semi-join probe as B3 sees it: the build is the orders whose
    # quantity passes the HAVING, padded to the join's shape bucket with
    # INT64_MAX; a chunk is R lineitem order keys in the probe's order
    nb = jk.shape_bucket(len(q18_build))
    sk = torch.from_numpy(np.concatenate(
        [q18_build, np.full(nb - len(q18_build), I64_MAX)])).cuda()
    pr = torch.from_numpy(np.ascontiguousarray(li.data["l_orderkey"][:R])).cuda()
    cap = hp.table_capacity(nb)
    tkeys, tlos, this, placed = hp.build_table(sk, cap)
    if not bool(placed):
        raise AssertionError("Q18's build left a run unplaced")
    check_probe_case(torch, hp, sk, pr)
    reads, _ = probe_slot_reads(torch, hp, tkeys, tlos, sk, pr)
    ms = device_ms(torch, lambda: hp.probe_table(tkeys, tlos, this, sk, pr), graph=True)
    plain_ms = device_ms(torch, lambda: hp.plain_probe_table(tkeys, tlos, this, sk, pr),
                         graph=False)
    library_ms = device_ms(torch, lambda: (torch.searchsorted(sk, pr),
                                           torch.searchsorted(sk, pr, right=True)),
                           graph=True)
    # keys in, (lo, hi) out, the table and the sorted keys read once
    nbytes = R * (8 + 16) + cap * 12 + nb * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (R * MIX_OPS + reads * SLOT_OPS) / SCALAR_OPS_PER_S * 1e3
    rows.append({
        "name": "hash_probe", "route": "cuda",
        "source": "tidb_tpu_torch/ops/csrc/hash_probe.cu",
        "replaces": "tidb_tpu/ops/hash_probe.py:244", "launches": launches["hash_probe"],
        "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    })
    log(f"hash_probe at R={R} cap={cap} runs={len(q18_build)} (slot reads {reads}): "
        f"{ms * 1e3:.2f} us/call, bound {max(bytes_ms, ops_ms) * 1e3:.3f} us "
        f"({nbytes} B), plain {plain_ms * 1e3:.2f} us, searchsorted x2 "
        f"{library_ms * 1e3:.2f} us")

    # tidb_probe_count at the main path's shapes, on the arguments the
    # run above gave it: Q18's semi join (the table route, flags only; also
    # timed in full), Q3's top join (direct) and Q5's two-key join (sorted);
    # and a table above the shared-memory limit (2^17 build rows, cap 2^18)
    def recorded(query, route, mode, seed):
        got = main_path_args(probes, query, route, mode)
        if got is not None:
            return got
        # no query of this plan took the route: a phase-1 case of the shape
        log(f"note: no main-path {route}/{mode} probe; timing a synthetic case")
        case = make_probe_count_case(torch, np, jk, hp, R, 1 << 12,
                                     {"route": route, "flags_only": mode == "flags"},
                                     seed, "cuda")
        return chunk_args(jk, case)

    q18_args, q18_kw = recorded("q18", "table", "flags", 4001)
    shapes = [
        ("probe_count.table_flags", q18_args, q18_kw, probe_modes.get("table/flags", 0)),
        ("probe_count.table_full", q18_args, dict(q18_kw, flags_only=False),
         probe_modes.get("table/full", 0)),
        ("probe_count.direct", *recorded("q3", "direct", "full", 4002),
         probe_modes.get("direct/full", 0)),
        ("probe_count.sorted", *recorded("q5", "sorted", "full", 4003),
         probe_modes.get("sorted/full", 0)),
    ]
    wl_direct_flags = main_path_args(wl_probes, "q95", "direct", "flags")
    if wl_direct_flags is None:
        raise AssertionError("no workload query probed the direct route flags-only")
    shapes.append(("probe_count.direct_flags", *wl_direct_flags,
                   probe_modes.get("direct/flags", 0)))
    del wl_probes
    big = make_probe_count_case(torch, np, jk, hp, R, 1 << 17, {"route": "table"}, 4999,
                                "cuda")
    shapes.append(("probe_count.table_cap_2e18", *chunk_args(jk, big), 0))
    for kname, args, kw, n_launch in shapes:
        rows.append(probe_chunk_row(torch, hp, kname, args, kw, n_launch))

    # -- the server phase: the MySQL protocol and the serving tier ----------
    server = with_probe_modes(hp, lambda: phase_server(torch, np, s, mods,
                                                        times["fused_cache"]))

    # -- the refresh phase: keys, index access and the write path ------------
    t0 = time.perf_counter()
    refresh = phase_refresh(torch, np, s, mods, load)
    refresh["s"] = time.perf_counter() - t0
    log(f"refresh phase passed in {refresh['s']:.1f} s")

    # -- the schema phase: compaction on and off, partitions, constraints,
    # DDL and transactions ----------------------------------------------------
    t0 = time.perf_counter()
    compaction_report = phase_compaction(np, s, mods)
    schema = phase_schema(torch, np, s, mods)
    schema["s"] = time.perf_counter() - t0
    log(f"schema phase passed in {schema['s']:.1f} s; launches {schema['launches']}")

    # -- statistics, EXPLAIN ANALYZE, windows and views -----------------------
    t0 = time.perf_counter()
    stats_report = with_probe_modes(hp, lambda: phase_stats(torch, np, s, mods))
    stats_report["s"] = time.perf_counter() - t0
    log(f"stats phase passed in {stats_report['s']:.1f} s; launches "
        f"{stats_report['launches']}; probe_count by route and mode "
        f"{stats_report['probe_modes']}")
    t0 = time.perf_counter()
    window = with_probe_modes(hp, lambda: phase_window(np, s, mods))
    window["s"] = time.perf_counter() - t0
    log(f"window phase passed in {window['s']:.1f} s; launches {window['launches']}; "
        f"probe_count by route and mode {window['probe_modes']}")
    storage = with_probe_modes(hp, lambda: phase_storage(torch, np, s, mods))
    log(f"storage phase passed in {storage['s']:.1f} s; launches {storage['launches']}; "
        f"probe_count by route and mode {storage['probe_modes']}")
    planner = with_probe_modes(hp, lambda: phase_planner(torch, np, s, mods))
    log(f"planner phase passed in {planner['s']:.1f} s; launches {planner['launches']}; "
        f"probe_count by route and mode {planner['probe_modes']}")
    mesh, mesh_shapes = phase_mesh(torch, np, s, mods, grid_cat, grid_oracle)
    by_mode = refresh["probe_modes"]
    for row in rows:
        if row["name"].startswith("probe_count."):
            mode = PROBE_ROW_MODES.get(row["name"])
            row["launches_refresh"] = by_mode.get(mode, 0)
        else:
            row["launches_refresh"] = refresh["launches"].get(row["name"], 0)
        if row["name"].startswith("probe_count."):
            row["launches_schema"] = schema["probe_modes"].get(mode, 0)
        else:
            row["launches_schema"] = schema["launches"].get(row["name"], 0)
        for key, rep in (("launches_stats", stats_report), ("launches_window", window),
                         ("launches_server", server), ("launches_storage", storage),
                         ("launches_planner", planner), ("launches_workloads", workloads)):
            row[key] = (rep["probe_modes"].get(mode, 0)
                        if row["name"].startswith("probe_count.")
                        else rep["launches"].get(row["name"], 0))
        # the mesh's launches sit on the rows at the mesh's own shapes
        row["launches_mesh"] = 0
    # the kernels at the mesh path's shapes: the mesh phase's launches
    mesh_rows = mesh_kernel_rows(torch, hp, seg_mod, mesh["launches"], mesh["probe_modes"],
                                 mesh_shapes)
    del mesh_shapes
    for row in mesh_rows:
        for key in ("launches_refresh", "launches_schema", "launches_stats",
                    "launches_window", "launches_server", "launches_storage",
                    "launches_planner", "launches_workloads"):
            row[key] = 0
        row["launches_mesh"] = row["launches"]
    rows += mesh_rows

    # -- the DCN tier: worker processes on the card --------------------------
    dcn = phase_dcn(torch, np, s)
    dcn_row_launches(rows, dcn)

    log(f"main-path launches: fused path {launches}, classic path {launches_classic}, "
        f"packed batches {launches_packed}, refresh phase {refresh['launches']}")
    report = {"card": card, "device": name, "lineitem_rows": n_rows,
              "warm_s": times, "cold_s": cold, "per_query": per_query,
              "classic_counts": classic_counts, "packed_batches": packed,
              "launches_by_path": {"fused": launches, "classic": launches_classic,
                                   "packed": launches_packed},
              "plans": plans, "probe_checks": probe_checks, "grid": grid,
              "sync_free": sync_free, "topn": topn, "peak_memory": memory,
              "segagg_checks": segagg_checks, "segagg_q1": segagg_q1,
              "probe_count_checks": probe_count_checks, "probe_modes": probe_modes,
              "sass_atomics": sass,
              "q18_probe": {"R": R, "cap": cap, "runs": len(q18_build),
                            "slot_reads": reads},
              "f32_max_abs_diff": errs["segsum_f32"], "profiles": profiles,
              "refresh": refresh, "cluster": cluster, "compaction": compaction_report,
              "schema": schema, "stats": stats_report, "window": window,
              "server": server, "storage": storage, "planner": planner, "mesh": mesh,
              "dcn": dcn, "workloads": workloads, "sanitized": sanitized,
              "graphs": graphs,
              "segsum_bench": segsum_bench, "kernels": rows}
    return rows, report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from tidb_tpu_torch.columnar import store as st
        from tidb_tpu_torch.executor import aggregate as agg_mod
        from tidb_tpu_torch.executor import pipeline as pl
        from tidb_tpu_torch.ops import hash_probe as hp
        from tidb_tpu_torch.ops import join_kernels as jk
        from tidb_tpu_torch.ops import nvcc_build
        from tidb_tpu_torch.ops import segment_sum as seg_mod
        from tidb_tpu_torch.session import Session  # noqa: F401 (the package is whole)
    except ImportError as e:
        print(f"chip_smoke: the tidb_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2

    # the slow-query log's rows still land in each catalog; its stderr
    # warning per statement over 300 ms would bury this script's output
    import logging

    logging.getLogger("tidb_tpu_torch.slowlog").setLevel(logging.ERROR)
    card = card_line()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")
    os.makedirs(OUT_DIR, exist_ok=True)
    mods = (seg_mod, hp, jk, pl, st, agg_mod)
    # before any CUDA graph is captured: the graphs hold the wrapper
    install_probe_wrapper(hp)

    t0 = time.perf_counter()
    nvcc_build.build_libraries([os.path.join(nvcc_build.CSRC, m.SOURCE)
                                for m in (seg_mod, hp)])
    seg_mod.load_kernels()
    hp.load_kernels()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    sass = {m.SOURCE: sass_atomics(nvcc_build._so_path(os.path.join(nvcc_build.CSRC, m.SOURCE)),
                                   nvcc_build.nvcc_path()) for m in (seg_mod, hp)}
    for src, found in sass.items():
        for fn, ops in found.items():
            log(f"SASS atomics {src} {str(fn)[:70]}: {ops}")

    rows, report = sf1_phases(torch, np, mods, card, name, sass)

    # -- SF10 on a fresh session, the SF1 sessions and their memory gone ------
    import gc

    gc.collect()
    pl.DEVICE_CACHE.clear()
    from tidb_tpu_torch.utils import jitcache

    jitcache.clear()
    torch.cuda.empty_cache()
    log(f"SF1 sessions closed: {torch.cuda.memory_allocated()} B allocated on the card")
    sf10 = phase_sf10(torch, np, mods)
    sf10_row_launches(rows, sf10)
    report["sf10"] = sf10
    report["kernels"] = rows
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
