"""The serving model stack (dense and hybrid families), ported from
`repro.models`."""
