"""Composable policy engine (port of `repro.core.ssd.policies`): `spec`
and `registry` name the compositions, `state`/`allocation`/`reclaim`/
`idle`/`engine` compute them on tensors."""
