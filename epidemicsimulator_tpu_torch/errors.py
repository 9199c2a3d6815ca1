"""Error taxonomy mirroring the reference's error types.

Engine side: ``sim/src/error.rs`` (SimError::Default/Simulation/
InitializationError).  Data side: ``load_census_data/src/parsing_error.rs``
(DataLoadingError variants + the ParseErrorType detail enum).  The Python
surface keeps the same partitions as exception subclasses so callers can
catch at either granularity, exactly like matching on the Rust enums.

The port's copy of ``epidemicsimulator_tpu/errors.py``, class for class.
"""

from __future__ import annotations


class SimError(Exception):
    """Engine-level failure (sim/src/error.rs SimError)."""


class SimInitializationError(SimError):
    """World/initialisation failure (SimError::InitializationError)."""


class SimulationRuntimeError(SimError):
    """Failure inside the step loop (SimError::Simulation)."""


# ---------------------------------------------------------------------------
# Data layer — parsing_error.rs DataLoadingError
# ---------------------------------------------------------------------------

class DataLoadingError(Exception):
    """Data-layer failure (parsing_error.rs:126-148 DataLoadingError)."""


class NetworkError(DataLoadingError):
    """Download failure (DataLoadingError::NetworkError)."""


class ShapeFileError(DataLoadingError):
    """Malformed or unsupported shapefile (DataLoadingError::ShapeFileError)."""


class ValueParsingError(DataLoadingError):
    """A value failed to parse or convert
    (DataLoadingError::ValueParsingError wrapping ParseErrorType)."""


class MissingDataError(ValueParsingError):
    """Expected key/column/value absent (ParseErrorType::MissingKey /
    ::IsEmpty)."""


class OutOfBoundsError(ValueParsingError):
    """Value outside its legal range (ParseErrorType::OutOfBounds)."""

    def __init__(self, context, max_size=None, actual_size=None):
        super().__init__(
            f"Out of bounds: {context}, max {max_size!r}, got {actual_size!r}"
        )
        self.max_size, self.actual_size = max_size, actual_size


class MismatchedDataError(ValueParsingError):
    """Two values should agree but don't (ParseErrorType::Mismatching)."""

    def __init__(self, message, value_1=None, value_2=None):
        super().__init__(f"{message}: {value_1!r} vs {value_2!r}")
        self.value_1, self.value_2 = value_1, value_2
