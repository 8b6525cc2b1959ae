"""``tests/test_getter.py`` against the port.

The reference's cases against the port, with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, and every
Server and ClusterServer given its scheduler config
(``backend="host"``, the reference's default, on ``device="cpu"``)
and every agent ``device="cpu"``.

Artifact getter breadth: git sources, checksum matrix, archive
options (reference client/allocrunner/taskrunner/getter/getter.go:22 —
go-getter's detector/option semantics).
"""

import hashlib
import os
import subprocess
import tarfile

import pytest

from nomad_tpu_torch.client.getter import ArtifactError, fetch_artifact
from nomad_tpu_torch.structs.structs import TaskArtifact


def _git(repo, *args):
    env = dict(os.environ)
    env.update({
        "GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
        "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t",
    })
    return subprocess.run(
        ["git", "-C", str(repo), *args],
        check=True, capture_output=True, text=True, env=env,
    ).stdout.strip()


@pytest.fixture
def git_repo(tmp_path):
    repo = tmp_path / "src-repo"
    repo.mkdir()
    subprocess.run(
        ["git", "init", "-q", "-b", "main", str(repo)],
        check=True, capture_output=True,
    )
    (repo / "app.conf").write_text("version=1\n")
    _git(repo, "add", ".")
    _git(repo, "commit", "-q", "-m", "v1")
    sha1 = _git(repo, "rev-parse", "HEAD")
    _git(repo, "tag", "v1.0")
    (repo / "app.conf").write_text("version=2\n")
    _git(repo, "commit", "-qam", "v2")
    sha2 = _git(repo, "rev-parse", "HEAD")
    return repo, sha1, sha2


def _task_dir(tmp_path, name="task"):
    d = tmp_path / name
    d.mkdir(parents=True, exist_ok=True)
    return str(d)


def test_git_clone_default_branch(git_repo, tmp_path):
    repo, _, _ = git_repo
    art = TaskArtifact(getter_source=f"git::file://{repo}", relative_dest="local/repo")
    dest = fetch_artifact(art, _task_dir(tmp_path))
    assert open(os.path.join(dest, "app.conf")).read() == "version=2\n"


def test_git_clone_tag_ref(git_repo, tmp_path):
    repo, _, _ = git_repo
    art = TaskArtifact(
        getter_source=f"git::file://{repo}?ref=v1.0", relative_dest="local/repo"
    )
    dest = fetch_artifact(art, _task_dir(tmp_path))
    assert open(os.path.join(dest, "app.conf")).read() == "version=1\n"


def test_git_clone_sha_ref(git_repo, tmp_path):
    repo, sha1, _ = git_repo
    art = TaskArtifact(
        getter_source=f"git::file://{repo}",
        getter_options={"ref": sha1},
        relative_dest="local/repo",
    )
    dest = fetch_artifact(art, _task_dir(tmp_path))
    assert open(os.path.join(dest, "app.conf")).read() == "version=1\n"


def test_git_dotgit_suffix_detected(git_repo, tmp_path):
    """A .git-suffixed path needs no git:: forcing (go-getter detector)."""
    repo, _, _ = git_repo
    bare = tmp_path / "mirror.git"
    subprocess.run(
        ["git", "clone", "-q", "--bare", str(repo), str(bare)],
        check=True, capture_output=True,
    )
    art = TaskArtifact(getter_source=str(bare), relative_dest="local/repo")
    dest = fetch_artifact(art, _task_dir(tmp_path))
    assert os.path.exists(os.path.join(dest, "app.conf"))


def test_git_file_source_respects_file_gate(git_repo, tmp_path):
    repo, _, _ = git_repo
    art = TaskArtifact(getter_source=f"git::file://{repo}")
    with pytest.raises(ArtifactError, match="file artifacts disabled"):
        fetch_artifact(art, _task_dir(tmp_path), allow_file=False)


def test_git_bad_ref_errors(git_repo, tmp_path):
    repo, _, _ = git_repo
    art = TaskArtifact(
        getter_source=f"git::file://{repo}?ref=no-such-branch"
    )
    with pytest.raises(ArtifactError, match="git clone"):
        fetch_artifact(art, _task_dir(tmp_path))


def test_checksum_bare_hex_infers_algorithm(tmp_path):
    payload = tmp_path / "blob.bin"
    payload.write_bytes(b"hello artifact")
    digest = hashlib.sha256(b"hello artifact").hexdigest()
    art = TaskArtifact(
        getter_source=str(payload), getter_options={"checksum": digest}
    )
    fetch_artifact(art, _task_dir(tmp_path))

    bad = TaskArtifact(
        getter_source=str(payload), getter_options={"checksum": "0" * 64}
    )
    with pytest.raises(ArtifactError, match="checksum mismatch"):
        fetch_artifact(bad, _task_dir(tmp_path, "t2"))


def test_checksum_md5_and_sha1(tmp_path):
    payload = tmp_path / "blob.bin"
    payload.write_bytes(b"abc")
    for algo in ("md5", "sha1"):
        digest = hashlib.new(algo, b"abc").hexdigest()
        art = TaskArtifact(
            getter_source=str(payload),
            getter_options={"checksum": f"{algo}:{digest}"},
        )
        fetch_artifact(art, _task_dir(tmp_path, f"t-{algo}"))


def test_checksum_unknown_length_errors(tmp_path):
    payload = tmp_path / "blob.bin"
    payload.write_bytes(b"abc")
    art = TaskArtifact(
        getter_source=str(payload), getter_options={"checksum": "abc123"}
    )
    with pytest.raises(ArtifactError, match="cannot infer"):
        fetch_artifact(art, _task_dir(tmp_path))


def _make_tarball(tmp_path, name="bundle.tar.gz"):
    src = tmp_path / "content"
    src.mkdir(exist_ok=True)
    (src / "data.txt").write_text("payload\n")
    tarball = tmp_path / name
    with tarfile.open(tarball, "w:gz") as tf:
        tf.add(src / "data.txt", arcname="data.txt")
    return tarball


def test_archive_false_disables_unpack(tmp_path):
    tarball = _make_tarball(tmp_path)
    art = TaskArtifact(
        getter_source=str(tarball), getter_options={"archive": "false"}
    )
    dest = fetch_artifact(art, _task_dir(tmp_path))
    assert os.path.exists(os.path.join(dest, "bundle.tar.gz"))
    assert not os.path.exists(os.path.join(dest, "data.txt"))


def test_archive_forced_format_for_extensionless(tmp_path):
    tarball = _make_tarball(tmp_path, name="bundle.bin")
    art = TaskArtifact(
        getter_source=str(tarball), getter_options={"archive": "tar.gz"}
    )
    dest = fetch_artifact(art, _task_dir(tmp_path))
    assert open(os.path.join(dest, "data.txt")).read() == "payload\n"
    assert not os.path.exists(os.path.join(dest, "bundle.bin"))


def test_url_query_options_parsed(tmp_path):
    """?archive=false rides the source URL go-getter style."""
    tarball = _make_tarball(tmp_path)
    art = TaskArtifact(getter_source=f"file://{tarball}?archive=false")
    dest = fetch_artifact(art, _task_dir(tmp_path))
    assert os.path.exists(os.path.join(dest, "bundle.tar.gz"))
    assert not os.path.exists(os.path.join(dest, "data.txt"))
