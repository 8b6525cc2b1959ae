"""Artifact fetcher.

Port of ``nomad_tpu/client/getter.py``.

Reference: client/allocrunner/taskrunner/getter/getter.go:22 (go-getter):
downloads artifacts into the task dir before start. Parity here:

  * sources: local paths / file://, http(s)://, git (forced `git::` or a
    `.git` suffix, with `ref=` for branches/tags/SHAs), and s3://
    (translated to the bucket's public HTTPS endpoint — no SDK).
  * options, via getter_options OR go-getter-style URL query params:
    - checksum = "[algo:]hex"  (md5/sha1/sha256/sha512; bare hex infers
      the algorithm from its length, as go-getter does)
    - archive  = "false" to disable auto-unpack, or an explicit format
      ("zip", "tar.gz", ...) to force unpacking extension-less files
    - ref      = git branch / tag / commit SHA
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import urllib.parse
import urllib.request

from ..structs.structs import TaskArtifact

ARCHIVE_EXTS = (".tar.gz", ".tgz", ".tar.bz2", ".tar.xz", ".tar", ".zip")

#: go-getter query params that are options, not part of the source URL
_OPTION_PARAMS = ("checksum", "archive", "ref", "depth")

#: bare-hex checksum length -> algorithm (go-getter checksum.go)
_HEX_ALGOS = {32: "md5", 40: "sha1", 64: "sha256", 128: "sha512"}


class ArtifactError(Exception):
    pass


def _file_artifacts_allowed() -> bool:
    """file:// and bare-path artifact sources read host files as the
    agent user; operators can disable them (the reference gates
    filesystem isolation per-agent the same way)."""
    return os.environ.get("NOMAD_TPU_ARTIFACT_ALLOW_FILE", "1") != "0"


def fetch_artifact(
    artifact: TaskArtifact,
    task_dir: str,
    env: dict[str, str] | None = None,
    allow_file: bool | None = None,
) -> str:
    """Fetch into task_dir/<relative_dest>; returns the destination."""
    from .allocdir import EscapeError, alloc_sandbox, confine
    from .taskenv import interpolate

    env = env or {}
    source = interpolate(artifact.getter_source, env)
    dest_rel = interpolate(artifact.relative_dest or "local/", env)
    # Job-controlled dest must stay inside the alloc dir.
    sandbox = alloc_sandbox(task_dir)
    try:
        dest = confine(sandbox, os.path.join(task_dir, dest_rel))
    except EscapeError as e:
        raise ArtifactError(str(e)) from e
    os.makedirs(dest, exist_ok=True)

    options = dict(artifact.getter_options or {})
    # go-getter forced scheme: "git::<real url>"
    forced = ""
    m = re.match(r"^([a-z0-9]+)::(.+)$", source)
    if m:
        forced, source = m.group(1), m.group(2)
    # go-getter option query params ride the source URL
    source, url_opts = _split_option_params(source)
    for k, v in url_opts.items():
        options.setdefault(k, v)

    parsed = urllib.parse.urlparse(source)
    if forced == "git" or parsed.path.endswith(".git"):
        if parsed.scheme in ("", "file") and not (
            _file_artifacts_allowed() if allow_file is None else allow_file
        ):
            # local-path git sources read host files like file:// does
            raise ArtifactError(
                "file artifacts disabled (NOMAD_TPU_ARTIFACT_ALLOW_FILE=0)"
            )
        if options.get("checksum"):
            # go-getter rejects checksums on directory sources; silently
            # dropping an integrity option would be worse
            raise ArtifactError("checksum is not supported for git sources")
        _fetch_git(source, options.get("ref", ""), dest)
        return dest
    if parsed.scheme == "s3":
        # public-bucket parity without an SDK: s3://bucket/key ->
        # https://bucket.s3.amazonaws.com/key (go-getter's s3 getter
        # additionally signs with credentials; out of scope here)
        source = f"https://{parsed.netloc}.s3.amazonaws.com{parsed.path}"
        parsed = urllib.parse.urlparse(source)
    if forced and forced not in ("git", "file", "http", "https"):
        raise ArtifactError(f"unsupported forced getter {forced!r}")
    if parsed.scheme in ("", "file"):
        if not (_file_artifacts_allowed() if allow_file is None else allow_file):
            raise ArtifactError(
                "file artifacts disabled (NOMAD_TPU_ARTIFACT_ALLOW_FILE=0)"
            )
        local = parsed.path if parsed.scheme == "file" else source
        if not os.path.exists(local):
            raise ArtifactError(f"artifact not found: {local}")
        fetched = local
        copied = os.path.join(dest, os.path.basename(local))
        if os.path.isdir(local):
            shutil.copytree(local, copied, dirs_exist_ok=True)
            return dest
        shutil.copy2(local, copied)
        fetched = copied
    elif parsed.scheme in ("http", "https"):
        name = os.path.basename(parsed.path) or "artifact"
        fetched = os.path.join(dest, name)
        try:
            with urllib.request.urlopen(source, timeout=30) as resp, open(
                fetched, "wb"
            ) as out:
                shutil.copyfileobj(resp, out)
        except Exception as e:
            raise ArtifactError(f"fetch {source}: {e}") from e
    else:
        raise ArtifactError(f"unsupported artifact scheme {parsed.scheme!r}")

    _verify_checksum(fetched, options.get("checksum", ""))

    archive_opt = str(options.get("archive", "")).lower()
    mode = artifact.getter_mode or "any"
    unpack_as = ""
    if archive_opt in ("false", "0", "no"):
        pass  # go-getter archive=false: never unpack
    elif archive_opt and archive_opt not in ("true", "1"):
        unpack_as = archive_opt  # forced format for extension-less files
    elif mode in ("any", "dir") and fetched.endswith(ARCHIVE_EXTS):
        unpack_as = "auto"
    if unpack_as:
        import tarfile

        try:
            if unpack_as == "auto":
                if fetched.endswith(".zip"):
                    # zipfile sanitizes member paths itself; tar needs
                    # the 'data' filter to block ../-traversal.
                    shutil.unpack_archive(fetched, dest)
                else:
                    shutil.unpack_archive(fetched, dest, filter="data")
            else:
                fmt = _SHUTIL_FORMATS.get(unpack_as)
                if fmt is None:
                    raise ArtifactError(
                        f"unknown archive format {unpack_as!r}"
                    )
                if fmt == "zip":
                    shutil.unpack_archive(fetched, dest, format=fmt)
                else:
                    shutil.unpack_archive(
                        fetched, dest, format=fmt, filter="data"
                    )
            os.unlink(fetched)
        except tarfile.FilterError as e:
            # A traversal attempt is an error in EVERY mode, never a
            # silently-ignored "not an archive".
            raise ArtifactError(f"unsafe archive {fetched}: {e}") from e
        except (shutil.ReadError, ValueError) as e:
            if mode == "dir" or unpack_as != "auto":
                raise ArtifactError(f"unpack {fetched}: {e}") from e
    return dest


_SHUTIL_FORMATS = {
    "zip": "zip",
    "tar": "tar",
    "tar.gz": "gztar",
    "tgz": "gztar",
    "tar.bz2": "bztar",
    "tar.xz": "xztar",
}


def _split_option_params(source: str) -> tuple[str, dict[str, str]]:
    """Pull go-getter option params (?checksum=&archive=&ref=) off the
    source URL; everything else stays for the server."""
    parsed = urllib.parse.urlparse(source)
    if not parsed.query:
        return source, {}
    opts: dict[str, str] = {}
    keep = []
    for k, v in urllib.parse.parse_qsl(parsed.query, keep_blank_values=True):
        if k in _OPTION_PARAMS:
            opts[k] = v
        else:
            keep.append((k, v))
    if not opts:
        # untouched: re-encoding would corrupt signature-sensitive
        # queries (presigned URLs encode spaces as %20, urlencode as +)
        return source, {}
    rebuilt = parsed._replace(query=urllib.parse.urlencode(keep))
    return urllib.parse.urlunparse(rebuilt), opts


def _fetch_git(source: str, ref: str, dest: str) -> None:
    """Clone a git source at ref into dest (reference: go-getter's git
    getter — clone, then checkout the requested ref; SHAs need the full
    history, branches/tags clone shallow)."""
    target = dest if not os.listdir(dest) else os.path.join(
        dest, os.path.basename(source.rstrip("/")).removesuffix(".git") or "repo"
    )
    is_sha = bool(re.fullmatch(r"[0-9a-f]{7,40}", ref))
    cmd = ["git", "clone", "--quiet"]
    if ref and not is_sha:
        cmd += ["--depth", "1", "--branch", ref]
    elif not ref:
        cmd += ["--depth", "1"]
    cmd += [source, target]
    env = dict(os.environ)
    env["GIT_TERMINAL_PROMPT"] = "0"  # never hang on credentials
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=120, env=env
        )
    except subprocess.TimeoutExpired as e:
        raise ArtifactError(f"git clone {source}: timed out") from e
    except FileNotFoundError as e:
        raise ArtifactError("git is not installed on this node") from e
    if proc.returncode != 0:
        raise ArtifactError(
            f"git clone {source}: {proc.stderr.strip() or proc.returncode}"
        )
    if is_sha:
        proc = subprocess.run(
            ["git", "-C", target, "checkout", "--quiet", ref],
            capture_output=True, text=True, timeout=60, env=env,
        )
        if proc.returncode != 0:
            raise ArtifactError(
                f"git checkout {ref}: {proc.stderr.strip() or proc.returncode}"
            )


def _verify_checksum(path: str, spec: str) -> None:
    if not spec:
        return
    algo, _, want = spec.partition(":")
    if not want:
        # bare hex: infer the algorithm from its length (go-getter)
        want = algo
        algo = _HEX_ALGOS.get(len(want), "")
        if not algo:
            raise ArtifactError(
                f"cannot infer checksum algorithm from {len(want)}-char hex"
            )
    try:
        h = hashlib.new(algo)
    except ValueError as e:
        raise ArtifactError(f"unknown checksum algorithm {algo!r}") from e
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    if h.hexdigest() != want.lower():
        raise ArtifactError(
            f"checksum mismatch for {os.path.basename(path)}: "
            f"got {h.hexdigest()}, want {want}"
        )
