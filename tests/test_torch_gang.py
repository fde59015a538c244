"""Gang scheduling through the port's shim against the JAX package's, by
outcome (tests/test_gang_e2e.py's traces): placeholders created and
reserved, the app Running once the gang is up, members replacing the
placeholders of their own task group, soft and hard timeouts, members
beyond minMember, leftover placeholders cleaned up on completion.

Each trace runs once on each package's mock scheduler with its core
started (the port on device="cpu"); placeholder names carry a random
suffix, so the outcome records counts, states and whether each member
landed on a node of its group's placeholders, not names.
"""
import json
import time

import pytest

from test_torch_shim import PORT, REF, new_mock, stop_mock, wait_until

TG = [{"name": "workers", "minMember": 3,
       "minResource": {"cpu": "500m", "memory": "256Mi"}}]
BIG_TG = [{"name": "big", "minMember": 2,
           "minResource": {"cpu": "100", "memory": "1Gi"}}]
MULTI_TG = [{"name": "drivers", "minMember": 1,
             "minResource": {"cpu": "1", "memory": "512Mi"}},
            {"name": "workers", "minMember": 4,
             "minResource": {"cpu": "500m", "memory": "256Mi"}}]


def gang_pod(p, name, app_id, task_groups, tg_name="", cpu=500,
             timeout_s=None, style=None):
    c = p.constants
    annotations = {c.ANNOTATION_TASK_GROUPS: json.dumps(task_groups)}
    if tg_name:
        annotations[c.ANNOTATION_TASK_GROUP_NAME] = tg_name
    params = []
    if timeout_s is not None:
        params.append(f"{c.SCHED_POLICY_TIMEOUT_PARAM}={timeout_s}")
    if style is not None:
        params.append(f"{c.SCHED_POLICY_STYLE_PARAM}={style}")
    if params:
        annotations[c.ANNOTATION_SCHED_POLICY_PARAM] = \
            c.SCHED_POLICY_PARAM_DELIMITER.join(params)
    return p.objects.make_pod(
        name, cpu_milli=cpu, memory=2**28,
        labels={c.LABEL_APPLICATION_ID: app_id}, annotations=annotations,
        scheduler_name=c.SCHEDULER_NAME)


def placeholders(p, ms, app_id, group=None):
    """The app's placeholder pods in the cluster (of one task group)."""
    c = p.constants
    return [pod for pod in ms.cluster.list_pods()
            if pod.metadata.annotations.get(c.ANNOTATION_PLACEHOLDER_FLAG)
            == c.TRUE
            and pod.metadata.labels.get(c.LABEL_APPLICATION_ID) == app_id
            and (group is None or pod.metadata.annotations.get(
                c.ANNOTATION_TASK_GROUP_NAME) == group)]


def wait_placeholders_gone(p, ms, app_id, timeout=10.0):
    wait_until(lambda: not placeholders(p, ms, app_id),
               f"{app_id}'s placeholders deleted", timeout)


def g_reserve_then_run(p, ms):
    ms.add_nodes([p.objects.make_node(f"n{i}", cpu_milli=4000)
                  for i in range(2)])
    origin = ms.add_pod(gang_pod(p, "driver", "gang-1", TG))
    ms.wait_for_app_state("gang-1", p.app.RUNNING, timeout=15)
    n_ph = len(placeholders(p, ms, "gang-1"))
    ms.wait_for_task_state("gang-1", origin.uid, p.task.BOUND)
    return {"placeholders_at_running": n_ph,
            "origin": ms.context.get_application("gang-1")
            .get_task(origin.uid).state}


def g_replacement(p, ms):
    ms.add_nodes([p.objects.make_node(f"n{i}", cpu_milli=4000)
                  for i in range(2)])
    ms.add_pod(gang_pod(p, "driver", "gang-2", TG))
    ms.wait_for_app_state("gang-2", p.app.RUNNING, timeout=15)
    ph_nodes = {pod.spec.node_name for pod in placeholders(p, ms, "gang-2")}
    members = [ms.add_pod(gang_pod(p, f"worker-{i}", "gang-2", TG,
                                   tg_name="workers")) for i in range(3)]
    for m in members:
        ms.wait_for_task_state("gang-2", m.uid, p.task.BOUND, timeout=15)
    wait_placeholders_gone(p, ms, "gang-2")
    return {"on_placeholder_nodes": [ms.get_pod_assignment(m) in ph_nodes
                                     for m in members],
            "placeholders_left": len(placeholders(p, ms, "gang-2"))}


def g_soft_timeout(p, ms):
    """Placeholders never fit; after the 1 s timeout the Soft style runs
    the app without its gang."""
    ms.add_node(p.objects.make_node("n0", cpu_milli=2000))
    origin = ms.add_pod(gang_pod(p, "driver", "gang-soft", BIG_TG,
                                 timeout_s=1, style="Soft"))
    ms.wait_for_app_state("gang-soft", p.app.RUNNING, timeout=20)
    ms.wait_for_task_state("gang-soft", origin.uid, p.task.BOUND, timeout=15)
    wait_placeholders_gone(p, ms, "gang-soft")
    return {"app": ms.context.get_application("gang-soft").state,
            "node": ms.get_pod_assignment(origin)}


def g_hard_timeout(p, ms):
    """The Hard style fails the app at the timeout."""
    ms.add_node(p.objects.make_node("n0", cpu_milli=2000))
    origin = ms.add_pod(gang_pod(p, "driver", "gang-hard", BIG_TG,
                                 timeout_s=1, style="Hard"))
    A = p.app

    def failed():
        app = ms.context.get_application("gang-hard")
        return app is None or app.state in (A.FAILING, A.FAILED)

    wait_until(lambda: ms.context.get_application("gang-hard") is not None,
               "gang-hard submitted")
    wait_until(failed, "gang-hard failing", timeout=20)
    wait_placeholders_gone(p, ms, "gang-hard")
    return {"failed": True, "node": ms.get_pod_assignment(origin)}


def g_multiple_task_groups(p, ms):
    ms.add_nodes([p.objects.make_node(f"mn{i}", cpu_milli=8000,
                                      memory=8 * 2**30) for i in range(3)])
    ms.add_pod(gang_pod(p, "origin", "gang-multi", MULTI_TG, cpu=200))
    ms.wait_for_app_state("gang-multi", p.app.RUNNING, timeout=20)
    n_ph = len(placeholders(p, ms, "gang-multi"))
    driver_nodes = {pod.spec.node_name for pod in
                    placeholders(p, ms, "gang-multi", "drivers")}
    worker_nodes = {pod.spec.node_name for pod in
                    placeholders(p, ms, "gang-multi", "workers")}
    d = ms.add_pod(gang_pod(p, "driver-0", "gang-multi", MULTI_TG,
                            tg_name="drivers", cpu=1000))
    ms.wait_for_task_state("gang-multi", d.uid, p.task.BOUND, timeout=15)
    workers = [ms.add_pod(gang_pod(p, f"wk-{i}", "gang-multi", MULTI_TG,
                                   tg_name="workers")) for i in range(4)]
    for w in workers:
        ms.wait_for_task_state("gang-multi", w.uid, p.task.BOUND, timeout=15)
    wait_placeholders_gone(p, ms, "gang-multi")
    return {"placeholders_at_running": n_ph,
            "driver_on_its_group": ms.get_pod_assignment(d) in driver_nodes,
            "workers_on_their_group": [ms.get_pod_assignment(w)
                                       in worker_nodes for w in workers]}


def g_extra_members(p, ms):
    """Members beyond minMember schedule through the normal path once the
    placeholders are used up."""
    ms.add_nodes([p.objects.make_node(f"xn{i}", cpu_milli=8000)
                  for i in range(2)])
    tgs = [{"name": "workers", "minMember": 2,
            "minResource": {"cpu": "500m", "memory": "256Mi"}}]
    ms.add_pod(gang_pod(p, "origin", "gang-extra", tgs, cpu=200))
    ms.wait_for_app_state("gang-extra", p.app.RUNNING, timeout=20)
    members = [ms.add_pod(gang_pod(p, f"xw-{i}", "gang-extra", tgs,
                                   tg_name="workers")) for i in range(5)]
    for m in members:
        ms.wait_for_task_state("gang-extra", m.uid, p.task.BOUND, timeout=20)
    wait_placeholders_gone(p, ms, "gang-extra")
    return {"members_bound": len(members)}


def g_completion_cleans_placeholders(p, ms):
    """Fewer members than minMember arrive and the app finishes: the
    leftover placeholders are deleted and their capacity freed."""
    ms.add_nodes([p.objects.make_node(f"cn{i}", cpu_milli=4000)
                  for i in range(2)])
    origin = ms.add_pod(gang_pod(p, "origin", "gang-clean", TG, cpu=200))
    ms.wait_for_app_state("gang-clean", p.app.RUNNING, timeout=20)
    n_ph = len(placeholders(p, ms, "gang-clean"))
    one = ms.add_pod(gang_pod(p, "only-worker", "gang-clean", TG,
                              tg_name="workers"))
    ms.wait_for_task_state("gang-clean", one.uid, p.task.BOUND, timeout=15)
    ms.wait_for_task_state("gang-clean", origin.uid, p.task.BOUND, timeout=15)
    ms.succeed_pod(one)
    ms.succeed_pod(origin)
    wait_placeholders_gone(p, ms, "gang-clean", timeout=20)
    c = p.constants
    probe = ms.add_pod(p.objects.make_pod(
        "probe", cpu_milli=3500,
        labels={c.LABEL_APPLICATION_ID: "probe-app"},
        scheduler_name=c.SCHEDULER_NAME))
    ms.wait_for_task_state("probe-app", probe.uid, p.task.BOUND, timeout=15)
    return {"placeholders_at_running": n_ph, "probe_bound": True}


GANG_TRACES = [g_reserve_then_run, g_replacement, g_soft_timeout,
               g_hard_timeout, g_multiple_task_groups, g_extra_members,
               g_completion_cleans_placeholders]


def run_gang(pkg, trace):
    p, ms = new_mock(pkg, queues_yaml="")
    try:
        ms.start()
        out = trace(p, ms)
        time.sleep(0.1)
        out["binds"] = ms.bind_stats().success_count
        return out
    finally:
        stop_mock(p, ms)


@pytest.mark.parametrize("trace", GANG_TRACES, ids=lambda t: t.__name__)
def test_gang_outcomes_match_reference(trace):
    ref = run_gang(REF, trace)
    port = run_gang(PORT, trace)
    assert port == ref


def test_gang_expected_outcomes():
    """The port's gang traces give what tests/test_gang_e2e.py expects."""
    assert run_gang(PORT, g_reserve_then_run)["placeholders_at_running"] == 3
    multi = run_gang(PORT, g_multiple_task_groups)
    assert multi["placeholders_at_running"] == 5
    assert multi["driver_on_its_group"]
    assert all(multi["workers_on_their_group"])
    assert all(run_gang(PORT, g_replacement)["on_placeholder_nodes"])


def test_placeholder_spec_copies_constraints():
    """The port's placeholder pod carries the task group's selector,
    tolerations and resources, as the JAX package's does."""
    import importlib

    specs = []
    for pkg in (REF, PORT):
        ph = importlib.import_module(f"{pkg}.cache.placeholder")
        si = importlib.import_module(f"{pkg}.common.si")
        res = importlib.import_module(f"{pkg}.common.resource")

        class App:
            application_id = "app-x"
            queue_name = "root.q"

            class metadata:
                owner_references = [{"kind": "Pod", "name": "o"}]

        tg = si.TaskGroup(name="tg1", min_member=2,
                          min_resource={"cpu": "1", "memory": "1Gi"},
                          node_selector={"zone": "a"},
                          tolerations=[{"key": "k", "operator": "Equal",
                                        "value": "v",
                                        "effect": "NoSchedule"}])
        name = ph.gen_placeholder_name("app-x", "tg1")
        assert name.startswith("tg-app-x-tg1-")
        pod = ph.new_placeholder(name, App, tg, None)
        specs.append((pod.spec.node_selector,
                       [(t.key, t.value, t.effect)
                        for t in pod.spec.tolerations],
                       pod.spec.scheduler_name,
                       dict(pod.metadata.annotations),
                       sorted(res.get_pod_resource(pod).resources.items())))
    # the placeholder's name (random suffix) is in its annotations only
    # through the task group; everything else must match
    assert specs[0] == specs[1]
