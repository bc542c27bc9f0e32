"""HEC-RAS unsteady flow (.uXX) files: parse, edit, emit.

A copy of ``gpras_tpu/data/flow_file.py`` (the port may not import the
JAX package, whose ``__init__`` imports jax).

Capability parity with the reference's flow-file layer (gpras/ras/flow.py:25-693):
initial conditions, flow-hydrograph and normal-depth boundary conditions with the
fixed-width ``Boundary Location`` header, the meteorological variable blocks
(Precipitation / Evapotranspiration / Wind family / Humidity / Air Temperature /
Air Density / Air Pressure), the non-Newtonian options block, and ASCII/CRLF
emission (HEC-RAS is byte-picky about these files).

Architecture (deliberately different from the reference's streaming line-trigger
consumers): the file is first **segmented** into prefix-keyed blocks in one pass,
then each block is handed to its section's ``parse`` — segmentation and
interpretation are decoupled, which makes round-trip tests and new sections
straightforward.

The 'Observed Time Series=...' group (calibration gage data the reference's
trigger parser silently DROPS, gpras/ras/flow.py:512-658) is captured
verbatim — block lines preserved in order, including continuation rows and
any 'Observed DSS ...' keys — and re-emitted after the boundary conditions,
so editing a file with observed data never loses it. The FlowOptions
template is still re-emitted wholesale (same as the reference).
"""

from __future__ import annotations

from typing import Any, Callable

# ---------------------------------------------------------------------------
# initial conditions
# ---------------------------------------------------------------------------


class InitialCondition:
    """One 'Initial Storage Elev' (2D) or 'IC Point Elev' row."""

    def __init__(self, idx: str, elevation: str, ic_type: str):
        if ic_type not in ("2D", "IC Point"):
            raise ValueError(f"Invalid initial-condition type {ic_type!r}")
        self.idx = idx
        self.elevation = elevation
        self.ic_type = ic_type

    def emit(self) -> str:
        if self.ic_type == "2D":
            return f"Initial Storage Elev={self.idx}    ,{self.elevation}"
        return f"IC Point Elev={self.idx}                      ,{self.elevation}"

    @classmethod
    def parse(cls, line: str) -> "InitialCondition":
        key, _, value = line.partition("=")
        if key == "Initial Storage Elev":
            ic_type = "2D"
        elif key == "IC Point Elev":
            ic_type = "IC Point"
        else:
            raise ValueError(f"Not an initial-condition row: {line!r}")
        # deviation from the reference (gpras/ras/flow.py:58, which strips
        # ALL spaces): HEC-RAS area names routinely contain interior spaces
        # ("Perimeter 1"); only the padding around the fields is stripped
        name, _, elev = value.rpartition(",")
        return cls(name.strip(), elev.strip(), ic_type)


class InitialConditions:
    """The 'Use Restart' flag plus the list of IC rows."""

    def __init__(self, ics: list[InitialCondition] | None = None,
                 use_restart: str = "0"):
        self.ics = ics or []
        self.use_restart = use_restart

    def emit(self) -> str:
        rows = "\n".join(ic.emit() for ic in self.ics)
        return f"Use Restart= {self.use_restart} \n{rows}"

    PREFIXES = ("Use Restart", "IC Point Elev", "Initial Storage Elev")

    def consume(self, block: str) -> None:
        first = block.split("\n", 1)[0]
        if first.startswith("Use Restart"):
            self.use_restart = first.partition("=")[2].strip()
        else:
            self.ics.append(InitialCondition.parse(first))


# ---------------------------------------------------------------------------
# boundary conditions
# ---------------------------------------------------------------------------

#: Column widths of the 9 comma-separated fields in a Boundary Location header;
#: HEC-RAS writes them space-padded (reference gpras/ras/flow.py:112-124).
_HEADER_WIDTHS = (16, 16, 8, 8, 16, 16, 16, 32, 32)


def _format_bc_header(sa_2d_id: str, mesh_name: str, bc_line_id: str) -> str:
    fields = ["", "", "", "", sa_2d_id, mesh_name, "", bc_line_id, ""]
    padded = [f.ljust(w) for f, w in zip(fields, _HEADER_WIDTHS)]
    return "Boundary Location=" + ",".join(padded)


def _parse_bc_header(line: str) -> dict[str, str]:
    fields = line.partition("=")[2].split(",")
    return {
        "sa_2d_id": fields[4],
        "mesh_name": fields[5],
        "bc_line_id": fields[7],
    }


class BoundaryCondition:
    """Common header handling; subclasses add their body rows."""

    def __init__(self, sa_2d_id: str, mesh_name: str, bc_line_id: str):
        self.sa_2d_id = sa_2d_id
        self.mesh_name = mesh_name
        self.bc_line_id = bc_line_id

    def body_rows(self) -> list[str]:
        return []

    def emit(self) -> str:
        rows = ["", _format_bc_header(self.sa_2d_id, self.mesh_name, self.bc_line_id)]
        rows.extend(self.body_rows())
        return "\n".join(rows) + "\n"


class NormalDepthBC(BoundaryCondition):
    """Normal-depth (friction slope) outlet (reference gpras/ras/flow.py:132-155)."""

    def __init__(self, friction_slope: str, bc_params_2d: str = "0", **header: str):
        super().__init__(**header)
        self.friction_slope = friction_slope
        self.bc_params_2d = bc_params_2d

    def body_rows(self) -> list[str]:
        return [f"Friction Slope={self.friction_slope},{self.bc_params_2d}"]

    @classmethod
    def parse(cls, block: str) -> "NormalDepthBC":
        header: dict[str, str] = {}
        slope, params = "0", "0"
        for line in block.split("\n"):
            if line.startswith("Boundary Location="):
                header = _parse_bc_header(line)
            elif line.startswith("Friction Slope="):
                vals = line.partition("=")[2].split(",")
                slope, params = vals[0], vals[1] if len(vals) > 1 else "0"
        return cls(slope, params, **header)


class FlowHydrographBC(BoundaryCondition):
    """DSS-linked flow hydrograph inlet (reference gpras/ras/flow.py:166-205)."""

    def __init__(self, interval: str = "", dss_file: str = "", dss_path: str = "",
                 **header: str):
        super().__init__(**header)
        self.interval = interval
        self.dss_file = dss_file
        self.dss_path = dss_path
        # defaults match the reference template (gpras/ras/flow.py:168-189);
        # parse() preserves file values (the reference resets them)
        self.flow_hydrograph = " 0 "
        self.flow_hydrograph_slope = ""

    def body_rows(self) -> list[str]:
        return [
            f"Interval={self.interval}",
            f"Flow Hydrograph={self.flow_hydrograph}",
            "Stage Hydrograph TW Check=0",
            f"Flow Hydrograph Slope= {self.flow_hydrograph_slope}",
            f"DSS File={self.dss_file}",
            f"DSS Path={self.dss_path}",
            "Use DSS=True",
            "Use Fixed Start Time=False",
            "Fixed Start Date/Time=,",
            "Is Critical Boundary=False",
            "Critical Boundary Flow=",
        ]

    @classmethod
    def parse(cls, block: str) -> "FlowHydrographBC":
        header: dict[str, str] = {}
        kwargs: dict[str, str] = {}
        extras: dict[str, str] = {}
        for line in block.split("\n"):
            if line.startswith("Boundary Location="):
                header = _parse_bc_header(line)
            elif line.startswith("Interval="):
                kwargs["interval"] = line.partition("=")[2]
            elif line.startswith("DSS File="):
                kwargs["dss_file"] = line.partition("=")[2]
            elif line.startswith("DSS Path="):
                kwargs["dss_path"] = line.partition("=")[2]
            elif line.startswith("Flow Hydrograph="):
                extras["flow_hydrograph"] = line.partition("=")[2]
            elif line.startswith("Flow Hydrograph Slope="):
                extras["flow_hydrograph_slope"] = line.partition("=")[2].lstrip()
        inst = cls(**kwargs, **header)
        for k, v in extras.items():
            setattr(inst, k, v)
        return inst


def parse_boundary_condition(block: str) -> BoundaryCondition:
    """Dispatch on the body content (reference gpras/ras/flow.py:208-215)."""
    for line in block.split("\n"):
        if line.startswith("Flow Hydrograph="):
            return FlowHydrographBC.parse(block)
        if line.startswith("Friction Slope="):
            return NormalDepthBC.parse(block)
    raise RuntimeError(f"No recognizable boundary condition in block:\n{block}")


class BoundaryConditions:
    def __init__(self, bcs: list[BoundaryCondition] | None = None):
        self.bcs = bcs or []

    PREFIXES = ("Boundary Location",)

    def consume(self, block: str) -> None:
        self.bcs.append(parse_boundary_condition(block))

    def emit(self) -> str:
        return "\n".join(bc.emit() for bc in self.bcs)


# ---------------------------------------------------------------------------
# meteorological variables
# ---------------------------------------------------------------------------


class MetVariable:
    """One 'Met BC=<param>|<key>=<value>' attribute group.

    The attribute order matters for byte-stable emission; ``attrs`` is an
    ordered dict of file-key -> value (None values are omitted on emit).
    """

    def __init__(self, param: str, attrs: dict[str, str | None]):
        self.param = param
        self.attrs = dict(attrs)

    def emit(self) -> str:
        return "\n".join(
            f"Met BC={self.param}|{k}={v}" for k, v in self.attrs.items()
            if v is not None
        )

    @property
    def prefixes(self) -> tuple[str, ...]:
        return tuple(f"Met BC={self.param}|{k}" for k in self.attrs)

    def consume(self, block: str) -> None:
        line = block.split("\n", 1)[0]
        key_val = line.partition("|")[2]
        k, _, v = key_val.partition("=")
        self.attrs[k] = v

    # convenience accessors used by run-maker code
    def set(self, key: str, value: str | None) -> None:
        self.attrs[key] = value

    def get(self, key: str) -> str | None:
        return self.attrs.get(key)


_BASE_MET_ATTRS: dict[str, str | None] = {
    "Mode": None,
    "Expanded View": "0",
    "Constant Value": None,
    "Constant Units": None,
    "Point Interpolation": "Nearest",
    "Gridded Source": "DSS",
}


def precipitation(mode: str | None = None, dss_filename: str | None = None,
                  dss_pathname: str | None = None) -> MetVariable:
    attrs = dict(_BASE_MET_ATTRS)
    attrs["Mode"] = mode
    attrs["Gridded DSS Filename"] = dss_filename
    attrs["Gridded DSS Pathname"] = dss_pathname
    return MetVariable("Precipitation", attrs)


def evapotranspiration() -> MetVariable:
    attrs = dict(_BASE_MET_ATTRS)
    attrs["Gridded DSS Filename"] = None
    attrs["Gridded DSS Pathname"] = None
    return MetVariable("Evapotranspiration", attrs)


def _simple_met(param: str) -> MetVariable:
    return MetVariable(param, {
        "Expanded View": "0",
        "Point Interpolation": "Nearest",
        "Gridded Source": "DSS",
    })


def air_density() -> MetVariable:
    return MetVariable("Air Density", {
        "Mode": "Constant", "Expanded View": "0", "Constant Value": "1.225",
        "Constant Units": "kg/m3", "Point Interpolation": "Nearest",
        "Gridded Source": "DSS",
    })


def air_pressure() -> MetVariable:
    return MetVariable("Air Pressure", {
        "Mode": "Constant", "Expanded View": "0", "Constant Value": "1013.2",
        "Constant Units": "mb", "Point Interpolation": "Inv Distance",
        "Gridded Source": "DSS",
    })


class Wind:
    """Wind group: mode + four component variables + air density
    (reference gpras/ras/flow.py:433-479)."""

    def __init__(self, mode: str = "No Wind Forces"):
        self.mode = mode
        self.speed = _simple_met("Wind Speed")
        self.direction = _simple_met("Wind Direction")
        self.velocity_x = _simple_met("Wind Velocity X")
        self.velocity_y = _simple_met("Wind Velocity Y")
        self.density = air_density()

    @property
    def variables(self) -> list[MetVariable]:
        return [self.speed, self.direction, self.velocity_x, self.velocity_y,
                self.density]

    def emit(self) -> str:
        return "\n".join(v.emit() for v in self.variables)


#: The non-Newtonian options block emitted verbatim at the end of the file
#: (reference gpras/ras/flow.py:512-542).
FLOW_OPTIONS_BLOCK = """Non-Newtonian Method= 0 ,
Non-Newtonian Constant Vol Conc=0
Non-Newtonian Yield Method= 0 ,
Non-Newtonian Yield Coef=0, 0
User Yeild=   0
Non-Newtonian Sed Visc= 0 ,
Non-Newtonian Obrian B=0
User Viscosity=0
User Viscosity Ratio=0
Herschel-Bulkley Coef=0, 0
Clastic Method= 0 ,
Coulomb Phi=0
Voellmy X=0
Non-Newtonian Hindered FV= 0
Non-Newtonian FV K=0
Non-Newtonian ds=0
Non-Newtonian Max Cv=0
Non-Newtonian Bulking Method= 0 ,
Non-Newtonian High C Transport= 0 ,
"""


# ---------------------------------------------------------------------------
# the file
# ---------------------------------------------------------------------------


class UnsteadyFlowFile:
    """Parse/edit/emit a .uXX file (reference gpras/ras/flow.py:545-693)."""

    def __init__(
        self,
        flow_title: str,
        program_version: str = "6.6",
        file_description: str = "",
        initial_conditions: InitialConditions | None = None,
        boundary_conditions: BoundaryConditions | None = None,
        precip_mode: str = "Disable",
        wind: Wind | None = None,
    ):
        self.flow_title = flow_title
        self.program_version = program_version
        self.file_description = file_description
        self.initial_conditions = initial_conditions or InitialConditions()
        self.boundary_conditions = boundary_conditions or BoundaryConditions()
        self.precip_mode = precip_mode
        self.wind = wind or Wind()
        self.air_density_mode = ""
        self.precipitation = precipitation()
        self.evapotranspiration = evapotranspiration()
        self.air_temperature = _simple_met("Air Temperature")
        self.humidity = _simple_met("Humidity")
        self.air_pressure = air_pressure()
        #: verbatim 'Observed Time Series=' blocks (calibration gage data);
        #: captured on parse, re-emitted unchanged — the reference drops them
        self.observed_time_series: list[str] = []

    # ----------------------------------------------------------------- emission

    def emit(self) -> str:
        parts = [
            f"Flow Title={self.flow_title}",
            f"Program Version={self.program_version}",
            "BEGIN FILE DESCRIPTION:",
            self.file_description,
            "END FILE DESCRIPTION:",
            self.initial_conditions.emit(),
            self.boundary_conditions.emit(),
            *self.observed_time_series,
            "Met Point Raster Parameters=,,,,",
            f"Precipitation Mode={self.precip_mode}",
            f"Wind Mode={self.wind.mode}",
            f"Air Density Mode={self.air_density_mode}",
            self.precipitation.emit(),
            self.evapotranspiration.emit(),
            self.wind.emit(),
            self.air_temperature.emit(),
            self.humidity.emit(),
            self.air_pressure.emit(),
            FLOW_OPTIONS_BLOCK,
        ]
        lines = [ln for ln in "\n".join(parts).split("\n") if ln != ""]
        return "\n".join(lines) + "\n"

    @property
    def lines(self) -> list[str]:
        return [ln + "\n" for ln in self.emit().rstrip("\n").split("\n")]

    def to_file(self, path: str) -> None:
        """ASCII + CRLF, the byte conventions HEC-RAS expects
        (reference gpras/ras/flow.py:689-692)."""
        with open(path, "w", encoding="ascii", newline="\r\n") as f:
            f.writelines(self.lines)

    # ------------------------------------------------------------------ parsing

    def _dispatch(self) -> dict[str, Callable[[str], None] | None]:
        table: dict[str, Any] = {}
        for p in InitialConditions.PREFIXES:
            table[p] = self.initial_conditions.consume
        for p in BoundaryConditions.PREFIXES:
            table[p] = self.boundary_conditions.consume
        for var in [self.precipitation, self.evapotranspiration,
                    self.air_temperature, self.humidity, self.air_pressure,
                    *self.wind.variables]:
            for p in var.prefixes:
                table[p] = var.consume
        table["Flow Title"] = self._set("flow_title")
        table["Program Version"] = self._set("program_version")
        table["BEGIN FILE DESCRIPTION:"] = self._consume_description
        table["Met Point Raster Parameters"] = None  # recognized, ignored
        table["Observed Time Series"] = self._consume_observed
        table["Precipitation Mode"] = self._set("precip_mode")
        table["Wind Mode"] = self._set_wind_mode
        table["Air Density Mode"] = self._set("air_density_mode")
        return table

    def _set(self, attr: str) -> Callable[[str], None]:
        def setter(block: str) -> None:
            setattr(self, attr, block.split("\n", 1)[0].partition("=")[2])

        return setter

    def _set_wind_mode(self, block: str) -> None:
        self.wind.mode = block.split("\n", 1)[0].partition("=")[2]

    def _consume_observed(self, block: str) -> None:
        self.observed_time_series.append(block)

    def _consume_description(self, block: str) -> None:
        body = [ln for ln in block.split("\n")
                if not ln.startswith(("BEGIN FILE DESCRIPTION:",
                                      "END FILE DESCRIPTION:"))]
        self.file_description = "\n".join(body)

    @classmethod
    def from_string(cls, text: str) -> "UnsteadyFlowFile":
        """Segment into prefix-keyed blocks, then parse each block."""
        inst = cls("")
        table = inst._dispatch()
        blocks: list[tuple[Callable[[str], None] | None, list[str]]] = []
        current: tuple[Callable[[str], None] | None, list[str]] | None = None
        for line in text.split("\n"):
            key = line.partition("=")[0] if "=" in line else line
            if key not in table and line.startswith("Met BC="):
                # met lines are 'Met BC=<param>|<attr>=<value>': the
                # registered prefix includes the attr, i.e. everything up to
                # the SECOND '=' — keying on the first '=' would silently
                # drop every meteorological attribute on parse
                pre, _, rest = line.partition("|")
                key = f"{pre}|{rest.partition('=')[0]}"
            if key in table:
                if current is not None:
                    blocks.append(current)
                current = (table[key], [line])
            elif current is not None:
                current[1].append(line)
        if current is not None:
            blocks.append(current)
        for consumer, lines in blocks:
            if consumer is not None:
                consumer("\n".join(lines))
        return inst

    @classmethod
    def from_file(cls, path: str) -> "UnsteadyFlowFile":
        with open(path) as f:
            return cls.from_string(f.read())
