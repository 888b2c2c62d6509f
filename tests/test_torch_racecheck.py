"""Race checking, both halves of ``-race`` — JAX's
``tests/test_racecheck.py`` run against the JAX package's
``utils/racecheck.py`` and the port's copy, parametrised: the auditor's
math, the lockset detector's, and the same integration workloads (a
daemon's hot locks, the storage manager's task map, the manager's job
plane) over each package's own modules. Each case finds the same
violations in both packages.
"""

from __future__ import annotations

import importlib
import threading

import pytest


@pytest.fixture(params=["dragonfly2_tpu", "dragonfly2_tpu_torch"],
                ids=["jax", "port"])
def rc(request):
    """The package's ``utils.racecheck`` module."""
    return importlib.import_module(f"{request.param}.utils.racecheck")


def _names(rc, module: str, *names):
    """``names`` from the racecheck module's package's ``module``."""
    package = rc.__name__.split(".")[0]
    mod = importlib.import_module(f"{package}.{module}")
    return tuple(getattr(mod, n) for n in names)


def _scheduler_factory(rc):
    """``tests/test_p2p_e2e.py``'s ``make_scheduler`` over the package's
    own scheduler modules."""
    (BaseEvaluator,) = _names(rc, "scheduler.evaluator", "BaseEvaluator")
    Scheduling, SchedulingConfig = _names(
        rc, "scheduler.scheduling", "Scheduling", "SchedulingConfig")
    (Resource,) = _names(rc, "scheduler.resource.resource", "Resource")
    (SchedulerService,) = _names(rc, "scheduler.service",
                                 "SchedulerService")
    (Storage,) = _names(rc, "scheduler.storage.storage", "Storage")

    def make_scheduler(tmp_path):
        return SchedulerService(
            resource=Resource(),
            scheduling=Scheduling(BaseEvaluator(), SchedulingConfig(
                retry_interval=0.01, retry_back_to_source_limit=2)),
            storage=Storage(str(tmp_path / "datasets")))

    return make_scheduler


class TestAuditorMath:
    def test_abba_cycle_detected_without_deadlocking(self, rc):
        """Two threads taking A→B and B→A at DIFFERENT times never
        deadlock in this schedule, but the order graph must still
        convict the pattern."""
        auditor = rc.LockOrderAuditor()
        a = auditor.wrap(threading.Lock(), "A")
        b = auditor.wrap(threading.Lock(), "B")

        def ab():
            with a:
                with b:
                    pass

        def ba():
            with b:
                with a:
                    pass

        t1 = threading.Thread(target=ab)
        t1.start()
        t1.join()
        t2 = threading.Thread(target=ba)
        t2.start()
        t2.join()
        with pytest.raises(rc.LockOrderViolation) as err:
            auditor.assert_acyclic()
        assert set(err.value.cycle) == {"A", "B"}

    def test_consistent_order_is_clean(self, rc):
        auditor = rc.LockOrderAuditor()
        a = auditor.wrap(threading.Lock(), "A")
        b = auditor.wrap(threading.Lock(), "B")
        c = auditor.wrap(threading.Lock(), "C")
        for _ in range(5):
            with a, b, c:
                pass
        with a, c:
            pass
        auditor.assert_acyclic()

    def test_reentrant_rlock_is_not_an_edge(self, rc):
        auditor = rc.LockOrderAuditor()
        r = auditor.wrap(threading.RLock(), "R")
        with r:
            with r:  # re-entry must not create R->R
                pass
        auditor.assert_acyclic()
        assert auditor.edges().get("R", set()) == set()

    def test_hand_over_hand_release(self, rc):
        """Out-of-LIFO release (lock coupling) must keep the held-stack
        coherent: after A-acquire, B-acquire, A-release, a C-acquire is
        ordered under B, not under the released A."""
        auditor = rc.LockOrderAuditor()
        a = auditor.wrap(threading.Lock(), "A")
        b = auditor.wrap(threading.Lock(), "B")
        c = auditor.wrap(threading.Lock(), "C")
        a.acquire()
        b.acquire()
        a.release()
        c.acquire()
        c.release()
        b.release()
        edges = auditor.edges()
        assert "C" in edges.get("B", set())
        assert "C" not in edges.get("A", set())

    def test_three_way_cycle(self, rc):
        auditor = rc.LockOrderAuditor()
        locks = {n: auditor.wrap(threading.Lock(), n) for n in "XYZ"}
        for first, second in (("X", "Y"), ("Y", "Z"), ("Z", "X")):
            with locks[first]:
                with locks[second]:
                    pass
        with pytest.raises(rc.LockOrderViolation):
            auditor.assert_acyclic()

    def test_cross_thread_edges_merge(self, rc):
        """Each thread contributes its own witnessed orders into ONE
        global graph — a cycle spread across threads is still found."""
        auditor = rc.LockOrderAuditor()
        a = auditor.wrap(threading.Lock(), "A")
        b = auditor.wrap(threading.Lock(), "B")
        done = threading.Barrier(2, timeout=5)

        def t1():
            with a:
                with b:
                    pass
            done.wait()

        def t2():
            done.wait()  # strictly after t1 — no real contention
            with b:
                with a:
                    pass

        threads = [threading.Thread(target=t1),
                   threading.Thread(target=t2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with pytest.raises(rc.LockOrderViolation):
            auditor.assert_acyclic()


class TestDaemonLockOrder:
    def test_concurrent_workload_is_acyclic(self, tmp_path, rc):
        """Wrap the daemon's hot locks and run concurrent downloads of
        distinct + shared tasks with interleaved deletes; the witnessed
        lock-order graph must be acyclic (deadlock-free by structure,
        not by luck of the schedule)."""
        from tests.fileserver import FileServer

        Daemon, DaemonConfig = _names(rc, "client.daemon", "Daemon",
                                      "DaemonConfig")
        make_scheduler = _scheduler_factory(rc)

        root = tmp_path / "origin"
        root.mkdir()
        for i in range(6):
            (root / f"f{i}.bin").write_bytes(bytes([i]) * 200_000)

        auditor = rc.LockOrderAuditor()
        with FileServer(str(root)) as origin:
            daemon = Daemon(make_scheduler(tmp_path), DaemonConfig(
                storage_root=str(tmp_path / "peer"), keep_storage=False))
            daemon.storage._lock = auditor.wrap(
                daemon.storage._lock, "storage.tasks")
            daemon._conductors_lock = auditor.wrap(
                daemon._conductors_lock, "daemon.conductors")
            daemon.start()
            try:
                errors = []

                def worker(i):
                    try:
                        for j in range(3):
                            name = f"f{(i + j) % 6}.bin"
                            r = daemon.download_file(origin.url(name))
                            assert r.success, r.error
                            if j == 1:
                                daemon.storage.delete_task(r.task_id)
                    except Exception as exc:  # noqa: BLE001
                        errors.append(exc)

                threads = [threading.Thread(target=worker, args=(i,))
                           for i in range(8)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                assert not errors, errors
            finally:
                daemon.stop()
        auditor.assert_acyclic()
        # Sanity: the workload really went through the wrapped locks.
        # (No EDGES is the expected verdict — the daemon never nests
        # these two locks, which is exactly the deadlock-free shape.)
        assert auditor.acquire_count > 50, auditor.acquire_count


def _run_threads(*targets, n_each: int = 1):
    threads = [threading.Thread(target=t, name=f"worker-{i}-{j}")
               for i, t in enumerate(targets) for j in range(n_each)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return threads


class TestLocksetMath:
    def test_unlocked_cross_thread_write_is_a_race(self, rc):
        det = rc.RaceDetector()
        shared = det.wrap_dict({}, "shared")

        def writer(val):
            def go():
                shared[val] = val  # no lock held
            return go

        # Sequential schedules — never actually interleaved, still a race.
        for t in _run_threads(writer(1)):
            t.join()
        for t in _run_threads(writer(2)):
            t.join()
        with pytest.raises(rc.DataRaceViolation) as err:
            det.assert_race_free()
        assert err.value.races[0].variable == "shared"

    def test_common_lock_is_clean(self, rc):
        det = rc.RaceDetector()
        lock = det.wrap(threading.Lock(), "L")
        shared = det.wrap_dict({}, "shared")

        def worker(i):
            def go():
                for j in range(50):
                    with lock:
                        shared[i * 100 + j] = j
                        _ = shared.get(j)
            return go

        _run_threads(worker(1), worker(2), worker(3))
        det.assert_race_free()
        assert det.access_count > 200

    def test_init_then_publish_is_exempt(self, rc):
        """Single-thread construction without locks, then lock-free
        READ-ONLY sharing: the exclusive phase plus the SHARED state
        must keep this silent (the Eraser false-positive guard)."""
        det = rc.RaceDetector()
        table = det.wrap_dict({}, "table")
        for i in range(20):
            table[i] = i * i  # main thread, no locks: init phase

        def reader():
            for i in range(20):
                assert table[i] == i * i  # no locks: still fine

        _run_threads(reader, reader, reader)
        det.assert_race_free()

    def test_write_after_read_sharing_is_a_race(self, rc):
        """Lock-free read-sharing is benign until someone WRITES while
        shared — then the empty candidate set convicts."""
        det = rc.RaceDetector()
        cell = det.cell("flag", value=0)
        cell.set(1)  # init

        def reader():
            cell.get()

        _run_threads(reader, reader)
        det.assert_race_free()  # read-only sharing: still clean

        def writer():
            cell.set(2)

        _run_threads(writer)
        with pytest.raises(rc.DataRaceViolation):
            det.assert_race_free()

    def test_disjoint_locks_convicted_without_interleaving(self, rc):
        """The classic wrong-lock bug: thread 1 guards the map with A,
        thread 2 guards it with B. Every individual access is locked and
        this schedule is strictly sequential — but no COMMON lock
        protects the variable, so some schedule corrupts it. The
        intersection-emptiness test catches it from this benign run."""
        det = rc.RaceDetector()
        a = det.wrap(threading.Lock(), "A")
        b = det.wrap(threading.Lock(), "B")
        shared = det.wrap_dict({}, "shared")

        def with_a():
            with a:
                shared["x"] = 1

        def with_b():
            with b:
                shared["x"] = 2

        # Three strictly-sequential accesses: A-locked write (init
        # phase), B-locked write (sharing begins, C={B}), A-locked write
        # (C={B}∩{A}=∅ → race). Matches Eraser's sensitivity: the
        # exclusive phase is exempt, so conviction needs the first
        # thread to come back after sharing begins — which any real
        # churn workload does.
        for fn in (with_a, with_b, with_a):
            for t in _run_threads(fn):
                t.join()
        with pytest.raises(rc.DataRaceViolation) as err:
            det.assert_race_free()
        assert err.value.races[0].variable == "shared"

    def test_superset_locksets_survive_refinement(self, rc):
        """Accesses holding {A,B} and {A} share A — the refined
        candidate set is {A}, non-empty, no race."""
        det = rc.RaceDetector()
        a = det.wrap(threading.Lock(), "A")
        b = det.wrap(threading.Lock(), "B")
        shared = det.wrap_dict({}, "shared")

        def both():
            with a, b:
                shared["k"] = 1

        def just_a():
            with a:
                shared["k"] = 2

        _run_threads(both, just_a, both, just_a)
        det.assert_race_free()

    def test_report_is_bounded_and_deduped(self, rc):
        det = rc.RaceDetector()
        cells = [det.cell(f"v{i}") for i in range(40)]

        def touch_all():
            for c in cells:
                c.set(1)

        _run_threads(touch_all, touch_all)
        races = det.races()
        assert 0 < len(races) <= rc.RaceDetector.MAX_REPORTS
        assert len({r.variable for r in races}) == len(races)


class TestStorageRaces:
    def test_storage_manager_task_map_race_free(self, tmp_path, rc):
        """Wrap the REAL StorageManager's lock and task map and churn it
        from 8 threads (register / read / reuse-scan / delete). Every
        access must be protected by the one storage lock — the lockset
        detector certifies the invariant for all schedules over these
        accesses, not just this run's."""
        StorageManager, StorageOptions = _names(
            rc, "client.storage", "StorageManager", "StorageOptions")

        det = rc.RaceDetector()
        mgr = StorageManager(StorageOptions(root=str(tmp_path / "s"),
                                            keep_storage=False))
        mgr._lock = det.wrap(mgr._lock, "storage.lock")
        mgr._tasks = det.wrap_dict(mgr._tasks, "storage.tasks")
        errors = []

        def churn(i):
            def go():
                try:
                    for j in range(15):
                        tid = f"task-{(i + j) % 5:040d}"
                        store = mgr.register_task(tid, f"peer-{i}")
                        store.update(content_length=10)
                        assert mgr.get(tid, f"peer-{i}") is not None
                        mgr.find_completed_task(tid)
                        if j % 5 == 4:
                            mgr.delete_task(tid, f"peer-{i}")
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
            return go

        _run_threads(*[churn(i) for i in range(8)])
        assert not errors, errors
        det.assert_race_free()
        det.assert_acyclic()
        assert det.access_count > 300, det.access_count

    def test_seeded_unprotected_access_is_caught(self, tmp_path, rc):
        """Mutate the same wrapped task map while BYPASSING the storage
        lock from one rogue thread — the detector must convict, proving
        the integration test above can actually fail."""
        StorageManager, StorageOptions = _names(
            rc, "client.storage", "StorageManager", "StorageOptions")

        det = rc.RaceDetector()
        mgr = StorageManager(StorageOptions(root=str(tmp_path / "s"),
                                            keep_storage=False))
        mgr._lock = det.wrap(mgr._lock, "storage.lock")
        mgr._tasks = det.wrap_dict(mgr._tasks, "storage.tasks")

        def legit():
            mgr.register_task("t" * 40, "peer-a")

        def rogue():
            mgr._tasks.pop(("nope", "nope"), None)  # no lock!

        for t in _run_threads(legit):
            t.join()
        for t in _run_threads(rogue):
            t.join()
        with pytest.raises(rc.DataRaceViolation) as err:
            det.assert_race_free()
        assert err.value.races[0].variable == "storage.tasks"


class TestJobPlaneLockOrder:
    def test_manager_job_plane_acyclic(self, tmp_path, rc):
        """Wrap the manager DB's RLock and the job bus lock while
        concurrent producers enqueue, workers lease/complete over the
        DurableJobStore, and REST reads race them — the witnessed
        acquisition graph must be acyclic."""
        Database, FilesystemObjectStore, ManagerService = _names(
            rc, "manager", "Database", "FilesystemObjectStore",
            "ManagerService")
        (DurableJobStore,) = _names(rc, "manager.jobplane", "DurableJobStore")
        (RestApi,) = _names(rc, "manager.rest", "RestApi")

        auditor = rc.LockOrderAuditor()
        db = Database(":memory:")
        db._lock = auditor.wrap(db._lock, "manager.db")
        service = ManagerService(
            db, FilesystemObjectStore(str(tmp_path / "objects")))
        store = DurableJobStore(db)
        api = RestApi(service, auth=None, jobstore=store)

        errors = []

        (Job,) = _names(rc, "manager.jobs", "Job")

        def producer(i):
            try:
                for j in range(5):
                    store.post("scheduler_1", Job(
                        id=f"j{i}-{j}", type="preheat",
                        payload={"url": f"http://o/{i}/{j}"},
                        group_id=f"g{i}"))
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        def worker(name):
            try:
                for _ in range(8):
                    job = store.lease(["scheduler_1"], worker_id=name)
                    if job is not None:
                        store.complete(job["id"], ok=True,
                                       result={"ok": 1}, worker_id=name)
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        def reader():
            try:
                for _ in range(10):
                    code, _ = api.dispatch("GET", "/api/v1/jobs", {}, {})
                    assert code == 200
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = ([threading.Thread(target=producer, args=(i,))
                    for i in range(3)]
                   + [threading.Thread(target=worker, args=(f"w{i}",))
                      for i in range(3)]
                   + [threading.Thread(target=reader) for _ in range(2)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        auditor.assert_acyclic()
        assert auditor.acquire_count > 30, auditor.acquire_count
