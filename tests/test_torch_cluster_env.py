"""``--multihost`` inside a cluster job, without ``--coordinator``, f64 CPU.

``main.py --multihost`` calls ``jax.distributed.initialize()``, which finds
an Open MPI or SLURM job's coordinator, process count and rank by itself.
``main_torch.plan_launch`` reads the same variables
(``main_torch.cluster_environment``): on the same environments it gives the
coordinator address, process count, rank and local rank that JAX's own
``OmpiCluster`` and ``SlurmCluster`` give, takes the counts missing beside
``--coordinator`` from the job, and refuses with one line only where neither
the flags nor a job give them.  Then two ``main_torch.py --cpu --multihost``
processes under a SLURM-like environment and no ``--coordinator`` train two
epochs (``tests/_torch_cli_runs.py``'s configuration).
"""

import socket

import pytest
from jax._src.clusters import ClusterEnv, OmpiCluster, SlurmCluster

import _torch_cli_runs as cr
import main_torch

OMPI_URIS = [
    "1531576320.0;tcp://10.96.0.1,10.148.0.1,10.108.0.1:34911",
    "1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,2620:10d:c083:150e::3000:2]:43370",
    "4096.0;tcp://node7:5000",
]
SLURM_NODELISTS = ["node001", "node001,host2", "node[001-0015],host2",
                   "node[001,007-015],host2", "gpu-a[12-14]", "host-3.cluster,host-4"]


def _slurm(nodes, job="4242", ntasks="8", procid="5", localid="1"):
    return {"SLURM_JOB_ID": job, "SLURM_STEP_NODELIST": nodes, "SLURM_NTASKS": ntasks,
            "SLURM_PROCID": procid, "SLURM_LOCALID": localid}


def _ompi(uri, size="6", rank="4", local="0"):
    return {"OMPI_MCA_orte_hnp_uri": uri, "OMPI_COMM_WORLD_SIZE": size,
            "OMPI_COMM_WORLD_RANK": rank, "OMPI_COMM_WORLD_LOCAL_RANK": local}


def _clear(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
              "JAX_COORDINATOR_PORT", "OMPI_MCA_orte_hnp_uri", "SLURM_JOB_ID",
              "SLURM_STEP_NODELIST", "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID"):
        monkeypatch.delenv(k, raising=False)


def _jax(cls):
    """What JAX's cluster class reads from this process's environment."""
    assert cls.is_env_present()
    return (cls.get_coordinator_address(None, None), cls.get_process_count(),
            cls.get_process_id(), cls.get_local_process_id())


def _port(address):
    return int(address.rpartition(":")[2])


@pytest.mark.parametrize("env,cls", [(_slurm(nl), SlurmCluster) for nl in SLURM_NODELISTS]
                         + [(_ompi(uri), OmpiCluster) for uri in OMPI_URIS],
                         ids=SLURM_NODELISTS + ["ompi_tcp", "ompi_tcp6", "ompi_host"])
def test_cluster_environment_reads_what_jax_reads(env, cls, monkeypatch):
    _clear(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = main_torch.cluster_environment()
    assert (got.coordinator, got.world_size, got.rank, got.local_rank) == _jax(cls)
    assert 61440 <= _port(got.coordinator) <= 65535
    # the port JAX_COORDINATOR_PORT names (jax.distributed.initialize passes it on)
    monkeypatch.setenv("JAX_COORDINATOR_PORT", "23456")
    got = main_torch.cluster_environment()
    assert got.coordinator == cls.get_coordinator_address(None, "23456")


def test_open_mpi_before_slurm_as_jax_tries_them(monkeypatch):
    """An Open MPI job inside a SLURM allocation carries both; JAX tries
    Open MPI first, and so does the port (torchrun's variables before
    either)."""
    names = [getattr(c, "name", None) for c in ClusterEnv._cluster_types]
    assert names.index("ompi") < names.index("slurm")
    _clear(monkeypatch)
    for k, v in dict(_slurm("node001"), **_ompi(OMPI_URIS[0])).items():
        monkeypatch.setenv(k, v)
    assert main_torch.cluster_environment().name == "ompi"
    for k, v in {"RANK": "2", "WORLD_SIZE": "3", "MASTER_ADDR": "h", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    assert main_torch.cluster_environment().name == "torchrun"


def test_a_bracketed_single_node_gives_its_host():
    """``node[001]``: the host is ``node001`` (JAX's parser keeps the ``]``)."""
    assert main_torch._slurm_first_host("node[001]") == "node001"
    assert main_torch._slurm_first_host("node[001],x") == "node001"


@pytest.mark.parametrize("flags,env,want", [
    # no --coordinator: the job's coordinator, counts and local rank
    (["--multihost"], _slurm("node[003-004]", job="100", ntasks="4", procid="2", localid="0"),
     (4, 2, "tcp://node003:61540", 0)),
    (["--multihost"], _ompi(OMPI_URIS[1], size="2", rank="1", local="1"),
     (2, 1, "tcp://[fe80::b9b:ac5d:9cf0:b858]:%d" % (61440 + 1314521088 // 4096 % 4096), 0)),
    # --coordinator with the counts from the job, or from the flags over it
    (["--multihost", "--coordinator", "h:7"], _slurm("n1", ntasks="8", procid="5"),
     (8, 5, "tcp://h:7", 0)),
    (["--multihost", "--coordinator", "h:7", "--num_processes", "4", "--process_id", "2"],
     _slurm("n1", ntasks="8", procid="5"), (4, 2, "tcp://h:7", 0)),
    (["--multihost", "--coordinator", "h:7", "--num_processes", "4", "--process_id", "2"],
     {}, (4, 2, "tcp://h:7", 0)),
])
def test_plan_launch_takes_what_the_flags_leave_from_the_job(flags, env, want):
    """Under ``--cpu`` one device: the local rank picks card 0 of 1."""
    plan = main_torch.plan_launch(main_torch.parse_args(["--cpu"] + flags), environ=env)
    assert (plan.world_size, plan.rank, plan.init_method, plan.local_index) == want
    assert not plan.spawn


@pytest.mark.parametrize("flags,env,says", [
    (["--multihost"], {}, "--multihost without --coordinator"),
    (["--multihost", "--coordinator", "h:7"], {}, "needs --num_processes and --process_id"),
    (["--multihost", "--coordinator", "h:7", "--num_processes", "2"], {},
     "needs --num_processes and --process_id"),
    # main.py fails here too: the mesh of the first 2 devices leaves the
    # processes that hold none of them without a shard (main.py:464)
    (["--multihost", "--num_devices", "2"], _slurm("n1", ntasks="4", procid="3"),
     "--num_devices 2 differs from its 4 processes"),
])
def test_plan_launch_refuses_with_one_line_where_no_job_gives_the_layout(flags, env, says):
    with pytest.raises(SystemExit) as err:
        main_torch.plan_launch(main_torch.parse_args(["--cpu"] + flags), environ=env)
    assert says in str(err.value) and "\n" not in str(err.value)


def _free_slurm_job():
    """A job id whose derived port (61440 + id mod 4096) is free here now."""
    for job in range(4096):
        with socket.socket() as s:
            try:
                s.bind(("localhost", 61440 + job))
            except OSError:
                continue
        return job
    pytest.fail("no free port in 61440-65535")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    folder = tmp_path_factory.mktemp("slurm")
    job = str(_free_slurm_job())
    envs = [_slurm("localhost", job=job, ntasks="2", procid=str(r), localid=str(r))
            for r in range(2)]
    outs = cr.launch(folder, ["--multihost"], ranks=(None, None), envs=envs)
    return {"folder": folder, "outs": outs}


def test_slurm_job_trains_one_run_directory_named_ndevices_2(run):
    cr.check_run_directory(run)


def test_slurm_job_data_txt_has_one_row_per_epoch(run):
    cr.check_data_txt(run)


def test_slurm_job_checksums_are_equal_across_ranks(run):
    cr.check_checksums(run)


def test_slurm_job_rank_0_pretrained_once(run):
    cr.check_pretrained_once(run)
