"""Error model of claxon_tpu_torch (a copy of ``claxon_tpu.error``).

Mirrors the reference's three-variant error enum (claxon `src/error.rs:17-32`):

* ``IoError``      -- a problem with the underlying IO (including unexpected
                      end-of-stream in the middle of a structure).
* ``FormatError``  -- an ill-formed FLAC stream was encountered (including
                      values that are *reserved* in the specification).
* ``Unsupported``  -- a feature that is in the FLAC specification but that
                      this library (like the reference) does not implement.

All errors carry a static message string; messages match the reference's
wording so differential tests can compare error behavior 1:1.
"""

__all__ = ["Error", "IoError", "FormatError", "Unsupported", "fmt_err"]


class Error(Exception):
    """Base class for all errors raised while decoding a FLAC stream."""

    def __eq__(self, other):
        # Mirrors claxon's PartialEq: same variant and same reason string.
        # IoError never compares equal (reference `src/error.rs:34-45`).
        if isinstance(self, IoError) or isinstance(other, IoError):
            return False
        return type(self) is type(other) and self.args == other.args

    def __hash__(self):
        return hash((type(self).__name__, self.args))


class IoError(Error):
    """Not a decoding error, but a problem with the underlying IO."""

    def __str__(self):
        return self.args[0] if self.args else "IO error"


class FormatError(Error):
    """An ill-formed FLAC stream was encountered."""

    def __str__(self):
        return "Ill-formed FLAC stream: " + (self.args[0] if self.args else "")


class Unsupported(Error):
    """A currently unsupported feature of the FLAC format was encountered."""

    def __str__(self):
        return ("A currently unsupported feature of the FLAC format was "
                "encountered: " + (self.args[0] if self.args else ""))


def fmt_err(reason):
    """Raise a FormatError with the given static reason.

    The reference returns ``Err(Error::FormatError(reason))``
    (`src/error.rs:100-102`); in Python we raise.
    """
    raise FormatError(reason)
