"""YAML-driven MPAS-Ocean ingest: stream config -> MPASMesh + raw solution
(mirror of mops_tpu.io.reader, building the port's MPASMesh).

Re-implementation of the reference IO layer (reference src/IO/MPASOReader.cpp
+ the ftk::stream YAML schema, mpas.yaml:1-100): a stream has a ``mesh``
substream (static connectivity/coordinates) and a ``data`` substream (time
series with ``possible_names`` aliasing, wildcard filenames, and
first-timestep-per-file indexing).  Float arrays are promoted to float64 like
the reference's ndarray copies.

The stream YAML is read by ``parse_yaml``, a parser of the subset the
schema uses (block mappings and ``- `` lists of mappings, flow lists
``[a, b]``, quoted and bare scalars, booleans, null, numbers and ``#``
comments), so the port needs no yaml package.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from typing import Dict, List, Optional

import numpy as np

from ..mesh import MPASMesh
from ..utils import timer
from .netcdf import NetCDFFile

# ---------------------------------------------------------------------------
# the stream schema's YAML subset
# ---------------------------------------------------------------------------

# PyYAML's (YAML 1.1) plain-scalar resolution for the forms handled here
_BOOLS = {"true": True, "True": True, "TRUE": True, "false": False,
          "False": False, "FALSE": False, "yes": True, "Yes": True,
          "YES": True, "no": False, "No": False, "NO": False, "on": True,
          "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULLS = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")


def _scan(text: str, stop):
    """Index of the first character outside quotes and brackets for which
    ``stop(text, i)`` holds, else -1.  A quote opens a string only at the
    start of a token."""
    quote, depth, i = None, 0, 0
    while i < len(text):
        ch = text[i]
        if quote:
            if ch == "\\" and quote == '"':
                i += 1
            elif ch == quote == "'" and text[i + 1:i + 2] == "'":
                i += 1                                   # '' inside '...'
            elif ch == quote:
                quote = None
        elif ch in "\"'" and (i == 0 or text[i - 1] in " \t[{,:"):
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif depth == 0 and stop(text, i):
            return i
        i += 1
    return -1


def _strip_comment(line: str) -> str:
    cut = _scan(line, lambda t, i: t[i] == "#" and (i == 0 or t[i - 1] in " \t"))
    return (line if cut < 0 else line[:cut]).rstrip()


def _key_colon(text: str) -> int:
    """Index of a mapping entry's ``:`` (followed by a space or the end)."""
    return _scan(text, lambda t, i: t[i] == ":" and (i + 1 == len(t)
                                                     or t[i + 1] in " \t"))


def _split_flow(text: str) -> List[str]:
    """Items of a flow collection's inside, split at top-level commas."""
    items = []
    while text.strip():
        cut = _scan(text, lambda t, i: t[i] == ",")
        items.append(text if cut < 0 else text[:cut])
        text = "" if cut < 0 else text[cut + 1:]
    return [s.strip() for s in items]


def _scalar(text: str):
    text = text.strip()
    if text.startswith('"') and text.endswith('"') and len(text) > 1:
        return json.loads(text)
    if text.startswith("'") and text.endswith("'") and len(text) > 1:
        return text[1:-1].replace("''", "'")
    if text.startswith("[") and text.endswith("]"):
        return [_scalar(s) for s in _split_flow(text[1:-1])]
    if text.startswith("{"):
        raise ValueError(f"flow mappings are outside the stream schema's "
                         f"YAML subset: {text!r}")
    if text in _BOOLS:
        return _BOOLS[text]
    if text in _NULLS:
        return None
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    return text


def _block(lines, i: int, indent: int):
    """Parse the block (a sequence or a mapping) whose first line is
    lines[i], at ``indent``; returns (value, index of the next line)."""
    text = lines[i][1]
    if text == "-" or text.startswith("- "):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _sequence(lines, i: int, indent: int):
    out = []
    while i < len(lines) and lines[i][0] == indent and (
            lines[i][1] == "-" or lines[i][1].startswith("- ")):
        text = lines[i][1]
        rest = text[1:].lstrip()
        if not rest:
            i += 1
            if i < len(lines) and lines[i][0] > indent:
                value, i = _block(lines, i, lines[i][0])
            else:
                value = None
        elif rest == "-" or rest.startswith("- ") or _key_colon(rest) >= 0:
            # "- key: value" opens a block at the column of "key"
            lines[i] = (indent + len(text) - len(rest), rest)
            value, i = _block(lines, i, lines[i][0])
        else:
            value, i = _scalar(rest), i + 1
        out.append(value)
    return out, i


def _mapping(lines, i: int, indent: int):
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        text = lines[i][1]
        if text == "-" or text.startswith("- "):
            break
        k = _key_colon(text)
        if k < 0:
            raise ValueError(f"not a mapping entry: {text!r}")
        key, rest = _scalar(text[:k]), text[k + 1:].strip()
        i += 1
        if rest:
            out[key] = _scalar(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and (lines[i][1] == "-"
                                           or lines[i][1].startswith("- ")))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def parse_yaml(text: str):
    """The document in ``text`` as dicts, lists and scalars, as
    yaml.safe_load gives them for the subset the stream schema uses."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw.replace("\t", "    "))
        if line.strip() and line.strip() not in ("---", "..."):
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return value


# canonical var name -> default possible_names (reference readSolData,
# src/IO/MPASOReader.cpp:215-227, and mpas.yaml aliasing)
SOL_VARS = {
    "bottomDepth": ["bottomDepth"],
    "seaSurfaceHeight": ["seaSurfaceHeight", "ssh",
                         "timeMonthly_avg_ssh"],
    "velocityZonal": ["velocityZonal", "timeMonthly_avg_velocityZonal",
                      "timeDaily_avg_velocityZonal"],
    "velocityMeridional": ["velocityMeridional",
                           "timeMonthly_avg_velocityMeridional",
                           "timeDaily_avg_velocityMeridional"],
    "layerThickness": ["layerThickness", "timeMonthly_avg_layerThickness",
                       "timeDaily_avg_layerThickness"],
    "zTop": ["zTop", "timeMonthly_avg_zTop"],
    "normalVelocity": ["normalVelocity", "timeMonthly_avg_normalVelocity",
                       "timeDaily_avg_normalVelocity"],
    "vertVelocityTop": ["vertVelocityTop", "timeMonthly_avg_vertVelocityTop"],
    "xtime": ["xtime", "xtime_startMonthly", "xtime_startDaily"],
    "temperature": ["temperature", "timeMonthly_avg_activeTracers_temperature"],
    "salinity": ["salinity", "timeMonthly_avg_activeTracers_salinity"],
}

GRID_VARS = ["xCell", "yCell", "zCell", "xVertex", "yVertex", "zVertex",
             "xEdge", "yEdge", "zEdge", "nEdgesOnCell", "verticesOnCell",
             "cellsOnVertex", "cellsOnCell", "cellsOnEdge", "edgesOnCell",
             "verticesOnEdge", "refBottomDepth"]


@dataclasses.dataclass
class Substream:
    name: str
    filenames: List[str]
    static: bool = False
    possible_names: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    optional: Dict[str, bool] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StreamConfig:
    """Parsed stream YAML (reference ftk stream schema, mpas.yaml:1-100)."""

    name: str
    path_prefix: str
    substreams: List[Substream]

    @classmethod
    def parse(cls, path: str,
              path_prefix_override: Optional[str] = None) -> "StreamConfig":
        with open(path) as f:
            doc = parse_yaml(f.read())
        stream = doc["stream"]
        prefix = path_prefix_override or stream.get("path_prefix", "")
        subs = []
        for s in stream.get("substreams", []):
            files = s.get("filenames", [])
            if isinstance(files, str):
                files = [files]
            resolved: List[str] = []
            for pattern in files:
                full = os.path.join(prefix, pattern) if prefix else pattern
                matches = sorted(glob.glob(full))
                resolved.extend(matches if matches else [full])
            possible, optional = {}, {}
            for var in s.get("vars", []) or []:
                name = var["name"]
                possible[name] = var.get("possible_names", [name])
                optional[name] = bool(var.get("optional", False))
            subs.append(Substream(name=s.get("name", ""), filenames=resolved,
                                  static=bool(s.get("static", False)),
                                  possible_names=possible, optional=optional))
        return cls(name=stream.get("name", "stream"), path_prefix=prefix,
                   substreams=subs)

    def substream(self, name: str) -> Substream:
        for s in self.substreams:
            if s.name == name:
                return s
        raise KeyError(name)


def _resolve(nc: NetCDFFile, aliases: List[str]) -> Optional[str]:
    for a in aliases:
        if nc.has(a):
            return a
    return None


class MPASOReader:
    """Reads grid + per-timestep solutions from a stream config.

    Usage mirrors the reference flow (MPASOReader::readGridData /
    readSolData, src/IO/MPASOReader.cpp:128-245):

        reader = MPASOReader(StreamConfig.parse("mpas.yaml"))
        mesh = reader.read_mesh()
        raw = reader.read_solution(timestep=0)
    """

    def __init__(self, config: StreamConfig):
        self.config = config
        mesh_sub = config.substream("mesh")
        if not mesh_sub.filenames:
            raise FileNotFoundError("mesh substream has no files")
        self.mesh_path = mesh_sub.filenames[0]
        self.mesh_name = os.path.splitext(os.path.basename(self.mesh_path))[0]
        try:
            self.data_sub = config.substream("data")
        except KeyError:
            self.data_sub = None
        self._timesteps_per_file: Optional[List[int]] = None

    # -- grid ---------------------------------------------------------------
    def read_mesh(self) -> MPASMesh:
        with timer("IO::readGridData", "IO_Read"), NetCDFFile(self.mesh_path) as nc:
            def rd(name):
                if not nc.has(name):
                    raise KeyError(f"{self.mesh_path}: missing grid var {name}")
                return nc.read(name)

            x, y, z = rd("xCell"), rd("yCell"), rd("zCell")
            cell_xyz = np.stack([x, y, z], axis=-1)
            vertex_xyz = np.stack([rd("xVertex"), rd("yVertex"), rd("zVertex")],
                                  axis=-1)
            edge_xyz = np.stack([rd("xEdge"), rd("yEdge"), rd("zEdge")], axis=-1)
            ref_bot = nc.read("refBottomDepth") if nc.has("refBottomDepth") else None
            return MPASMesh.from_raw(
                cell_xyz=cell_xyz, vertex_xyz=vertex_xyz, edge_xyz=edge_xyz,
                n_edges_on_cell=rd("nEdgesOnCell"),
                vertices_on_cell_1based=rd("verticesOnCell"),
                cells_on_cell_1based=rd("cellsOnCell"),
                cells_on_vertex_1based=rd("cellsOnVertex"),
                edges_on_cell_1based=rd("edgesOnCell"),
                cells_on_edge_1based=rd("cellsOnEdge"),
                vertices_on_edge_1based=rd("verticesOnEdge"),
                ref_bottom_depth=ref_bot,
                name=self.mesh_name)

    # -- time series --------------------------------------------------------
    def _file_timesteps(self) -> List[int]:
        """Number of Time entries per data file (for global-index lookup,
        reference first_timestep_per_file, src/IO/MPASOReader.cpp:183-196)."""
        if self._timesteps_per_file is None:
            counts = []
            for path in self.data_sub.filenames:
                with NetCDFFile(path) as nc:
                    n = nc.dimension_size("Time")
                    counts.append(n if n else 1)
            self._timesteps_per_file = counts
        return self._timesteps_per_file

    def locate(self, global_timestep: int):
        """global timestep -> (file path, local index)."""
        counts = self._file_timesteps()
        t = global_timestep
        for path, n in zip(self.data_sub.filenames, counts):
            if t < n:
                return path, t
            t -= n
        raise IndexError(f"timestep {global_timestep} beyond "
                         f"{sum(counts)} available")

    def read_solution(self, timestep: int = 0,
                      data_name: Optional[str] = None,
                      extra_attrs: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
        """Raw solution arrays for one timestep (NetCDF-named, Time-squeezed).

        ``data_name``: substring to select a specific data file (reference
        readSolData file matching, src/IO/MPASOReader.cpp:183-196).
        """
        if self.data_sub is None:
            raise RuntimeError("no data substream in config")
        if data_name is not None:
            matches = [p for p in self.data_sub.filenames if data_name in p]
            if not matches:
                raise FileNotFoundError(f"no data file containing {data_name!r}")
            path, local_t = matches[0], timestep
        else:
            path, local_t = self.locate(timestep)

        out: Dict[str, np.ndarray] = {}
        wanted = dict(SOL_VARS)
        for extra in (extra_attrs or []):
            wanted.setdefault(extra, [extra])
        # stream-config aliasing wins over defaults
        for var, aliases in self.data_sub.possible_names.items():
            for canon, defaults in wanted.items():
                if var == canon or any(a in defaults for a in aliases):
                    wanted[canon] = list(dict.fromkeys(aliases + defaults))

        with timer("IO::readSolData", "IO_Read"), NetCDFFile(path) as nc:
            for canon, aliases in wanted.items():
                actual = _resolve(nc, aliases)
                if actual is None:
                    continue
                arr = nc.read_timestep(actual, local_t)
                if canon == "xtime":
                    out["xtime"] = arr
                    continue
                out[canon] = np.squeeze(arr)
        if "xtime" in out:
            raw = out.pop("xtime")
            out["_timestamp"] = bytes(np.asarray(raw).ravel()[:64]).decode(
                "ascii", "ignore").strip("\x00 ").strip()
        return out
