//! Golden-vector capture harness for the ligero-jax bit-exactness contract.
//!
//! Replays the reference test harness (reference src/ligero/tests.rs:144-170
//! `proof_and_verify`, :364-415 `test_poseidon`) against the PINNED
//! dependency revisions and dumps, as JSON under --out (default ../../tests/golden):
//!
//!   * sponge_probes.json     — PoseidonSponge test-parameter absorb/squeeze
//!                              sequences (closes VERIFY_NOTES #4, #5)
//!   * calculate_t.json       — ark-poly-commit calculate_t over the bench
//!                              grid (closes VERIFY_NOTES #11)
//!   * prng_streams.json      — F::rand streams + distinct-index sampling
//!                              (confirms VERIFY_NOTES #8, #9, #10)
//!   * r1cs_<fixture>.json    — ark-relations/ark-circom constraint rows
//!                              (closes VERIFY_NOTES #13)
//!   * proof_<fixture>.json   — full FS-level capture: dims, u_root, every
//!                              per-step squeezed seed, preenc_u_lc, q/p0
//!                              coefficients, opened index sets, columns,
//!                              auth paths
//!
//! Run via capture.sh on a machine with a Rust toolchain + network access.

use std::{fs, path::PathBuf, str::FromStr};

use ark_bls12_377::Fq as FqBLS;
use ark_bn254::Fr as FrBN;
use ark_crypto_primitives::sponge::{
    poseidon::PoseidonSponge, Absorb, CryptographicSponge,
};
use ark_ec::short_weierstrass::Affine;
use ark_bls12_377::G1Affine;
use ark_ff::{Field, PrimeField, UniformRand};
use ark_poly_commit::{linear_codes::calculate_t, test_sponge};
use ark_serialize::CanonicalSerialize;
use ark_std::test_rng;
use blake2::{Blake2s256, Digest};
use serde_json::{json, Map, Value};

use ligero::{
    arithmetic_circuit::ArithmeticCircuit,
    ligero::{types::LigeroMTTestParams, LigeroCircuit},
    reader::read_constraint_system,
    utils::{get_distinct_indices_from_prng, get_field_elements_from_prng},
    DEFAULT_SECURITY_LEVEL,
};

fn dec<F: PrimeField>(f: &F) -> String {
    f.into_bigint().to_string()
}

fn dec_vec<F: PrimeField>(v: &[F]) -> Vec<String> {
    v.iter().map(dec).collect()
}

fn write_json(outdir: &PathBuf, name: &str, v: &Value) {
    let path = outdir.join(name);
    fs::write(&path, serde_json::to_string_pretty(v).unwrap()).unwrap();
    println!("wrote {}", path.display());
}

/// Blake2s-256 of serialize_compressed(column), i.e. exactly what
/// FieldToBytesColHasher feeds the Merkle leaves.
fn col_digest<F: PrimeField + CanonicalSerialize>(col: &Vec<F>) -> String {
    let mut buf = Vec::new();
    col.serialize_compressed(&mut buf).unwrap();
    hex::encode(Blake2s256::digest(&buf))
}

// ---------------------------------------------------------------- sponge

fn sponge_probes<F: PrimeField + Absorb>(field_name: &str) -> Value {
    let mut probes = Vec::new();

    // (a) squeeze with no absorb
    let mut s: PoseidonSponge<F> = test_sponge();
    probes.push(json!({
        "name": "squeeze_fresh_32",
        "ops": [{"squeeze_bytes": 32}],
        "out_hex": [hex::encode(s.squeeze_bytes(32))],
    }));

    // (b) absorb 32 zero bytes (u_root-shaped), squeeze 32
    let mut s: PoseidonSponge<F> = test_sponge();
    s.absorb(&vec![0u8; 32]);
    probes.push(json!({
        "name": "absorb_32_zero_bytes",
        "ops": [{"absorb_bytes_len": 32}, {"squeeze_bytes": 32}],
        "out_hex": [hex::encode(s.squeeze_bytes(32))],
    }));

    // (c) absorb 37 counting bytes (crosses the 31-byte packing boundary)
    let bytes: Vec<u8> = (0u8..37).collect();
    let mut s: PoseidonSponge<F> = test_sponge();
    s.absorb(&bytes);
    probes.push(json!({
        "name": "absorb_37_counting_bytes",
        "ops": [{"absorb_bytes_hex": hex::encode(&bytes)}, {"squeeze_bytes": 32}],
        "out_hex": [hex::encode(s.squeeze_bytes(32))],
    }));

    // (d) absorb a field-element vector
    let elems: Vec<F> = (0u64..5).map(|i| F::from(i * 1_000_003 + 7)).collect();
    let mut s: PoseidonSponge<F> = test_sponge();
    s.absorb(&elems);
    probes.push(json!({
        "name": "absorb_5_field_elems",
        "elems_dec": dec_vec(&elems),
        "out_hex": [hex::encode(s.squeeze_bytes(32))],
    }));

    // (e) FS-shaped interleaving: bytes, squeeze, field vec, squeeze,
    //     field vec, squeeze — exercises every mode transition
    let mut s: PoseidonSponge<F> = test_sponge();
    let mut outs = Vec::new();
    s.absorb(&vec![0xA5u8; 32]);
    outs.push(hex::encode(s.squeeze_bytes(32)));
    s.absorb(&elems);
    outs.push(hex::encode(s.squeeze_bytes(32)));
    let elems2: Vec<F> = (0u64..3).map(|i| F::from(i + 1) * F::from(2u64).pow([200u64])).collect();
    s.absorb(&elems2);
    outs.push(hex::encode(s.squeeze_bytes(32)));
    probes.push(json!({
        "name": "fs_shaped_interleaving",
        "bytes_hex": hex::encode(vec![0xA5u8; 32]),
        "elems_dec": dec_vec(&elems),
        "elems2_dec": dec_vec(&elems2),
        "out_hex": outs,
    }));

    // (f) long squeeze (65 bytes: forces multiple squeeze elements + a
    //     partial trailing element)
    let mut s: PoseidonSponge<F> = test_sponge();
    s.absorb(&vec![0x5Au8; 32]);
    probes.push(json!({
        "name": "squeeze_65_bytes",
        "out_hex": [hex::encode(s.squeeze_bytes(65))],
    }));

    json!({"field": field_name, "probes": probes})
}

// ----------------------------------------------------------- calculate_t

fn calculate_t_grid() -> Value {
    let mut rows = Vec::new();
    // Every (k, n=8k) the fixtures/bench configs use, plus one size beyond.
    for log2k in 2..=14u32 {
        let k = 1usize << log2k;
        let n = 8 * k;
        let t_fr = calculate_t::<FrBN>(DEFAULT_SECURITY_LEVEL, (n - k + 1, n), n).unwrap();
        let t_fq = calculate_t::<FqBLS>(DEFAULT_SECURITY_LEVEL, (n - k + 1, n), n).unwrap();
        rows.push(json!({"k": k, "n": n, "lambda": DEFAULT_SECURITY_LEVEL,
                         "t_bn254_fr": t_fr, "t_bls12_377_fq": t_fq}));
    }
    // Off-nominal lambdas at one shape (robustness cross-check)
    for lambda in [80usize, 100, 128] {
        let (k, n) = (1024usize, 8192usize);
        let t = calculate_t::<FrBN>(lambda, (n - k + 1, n), n).unwrap();
        rows.push(json!({"k": k, "n": n, "lambda": lambda, "t_bn254_fr": t}));
    }
    json!({"rows": rows})
}

// ---------------------------------------------------------------- PRNG

fn prng_streams() -> Value {
    let seeds: Vec<[u8; 32]> = vec![
        [0u8; 32],
        core::array::from_fn(|i| i as u8),
        [0xAB; 32],
    ];
    let mut entries = Vec::new();
    for seed in &seeds {
        let fr: Vec<FrBN> = get_field_elements_from_prng(16, *seed);
        let fq: Vec<FqBLS> = get_field_elements_from_prng(8, *seed);
        let idx_small = get_distinct_indices_from_prng(1024, 156, *seed);
        let idx_compl = get_distinct_indices_from_prng(32, 30, *seed); // complement path
        entries.push(json!({
            "seed_hex": hex::encode(seed),
            "fr_bn254_dec": dec_vec(&fr),
            "fq_bls377_dec": dec_vec(&fq),
            "distinct_1024_156": idx_small,
            "distinct_32_30": idx_compl,
        }));
    }
    json!({"streams": entries})
}

// ---------------------------------------------------------------- R1CS

fn r1cs_rows(r1cs: &str, wasm: &str) -> Value {
    let cs = read_constraint_system::<FrBN>(r1cs, wasm);
    let matrices = cs.to_matrices().unwrap();
    let dump = |m: &Vec<Vec<(FrBN, usize)>>| -> Value {
        Value::Array(
            m.iter()
                .map(|row| {
                    Value::Array(
                        row.iter()
                            .map(|(c, i)| json!([dec(c), i]))
                            .collect(),
                    )
                })
                .collect(),
        )
    };
    json!({
        "num_instance_variables": cs.num_instance_variables,
        "num_witness_variables": cs.num_witness_variables,
        "num_constraints": cs.num_constraints,
        "a": dump(&matrices.a),
        "b": dump(&matrices.b),
        "c": dump(&matrices.c),
    })
}

// ---------------------------------------------------------------- proofs

/// Prove with the reference, then replay the FS transcript from the public
/// proof fields, recording every squeezed seed (SURVEY.md §4 steps 2,4,5,7,8,10).
fn capture_proof<F: PrimeField + Absorb + CanonicalSerialize>(
    name: &str,
    circuit: ArithmeticCircuit<F>,
    outputs: Vec<usize>,
    vars: Vec<(usize, F)>,
    full_columns: bool,
) -> Value {
    let ligero = LigeroCircuit::new(circuit, outputs, DEFAULT_SECURITY_LEVEL);
    let (m, k, n, t) = (ligero.m, ligero.k, ligero.n, ligero.t);
    let sponge: PoseidonSponge<F> = test_sponge();
    let mt_params = LigeroMTTestParams::new();

    let proof = ligero.prove(vars.clone(), &mt_params, &mut sponge.clone());

    // FS replay (prover order, SURVEY.md §4)
    let mut sp = sponge.clone();
    sp.absorb(&proof.u_root);
    let seed_r_interleaved = sp.squeeze_bytes(32);
    let r_interleaved: Vec<F> =
        get_field_elements_from_prng(4 * m, seed_r_interleaved.clone().try_into().unwrap());
    sp.absorb(&proof.interleaved_proof.preenc_u_lc);
    let seed_idx_interleaved = sp.squeeze_bytes(32);
    let idx_interleaved =
        get_distinct_indices_from_prng(n, t, seed_idx_interleaved.clone().try_into().unwrap());
    let seed_r_linear = sp.squeeze_bytes(32);
    let r_linear: Vec<F> =
        get_field_elements_from_prng(4 * m * k, seed_r_linear.clone().try_into().unwrap());
    sp.absorb(&proof.linear_constraints_proof.polynomial.coeffs);
    let seed_idx_linear = sp.squeeze_bytes(32);
    let idx_linear =
        get_distinct_indices_from_prng(n, t, seed_idx_linear.clone().try_into().unwrap());
    let seed_r_quadratic = sp.squeeze_bytes(32);
    let r_quadratic: Vec<F> =
        get_field_elements_from_prng(m, seed_r_quadratic.clone().try_into().unwrap());
    sp.absorb(&proof.quadratic_constraints_proof.polynomial.coeffs);
    let seed_idx_quadratic = sp.squeeze_bytes(32);
    let idx_quadratic =
        get_distinct_indices_from_prng(n, t, seed_idx_quadratic.clone().try_into().unwrap());

    // Cross-check the replayed index sets against the proof's path indices.
    for (idx, sub) in [
        (&idx_interleaved, &proof.interleaved_proof.paths),
        (&idx_linear, &proof.linear_constraints_proof.paths),
        (&idx_quadratic, &proof.quadratic_constraints_proof.paths),
    ] {
        let path_idx: Vec<usize> = sub.iter().map(|p| p.leaf_index).collect();
        assert_eq!(**idx, path_idx, "replayed indices diverge from proof paths");
    }

    let dump_columns = |columns: &Vec<Vec<F>>| -> Value {
        if full_columns {
            Value::Array(columns.iter().map(|c| json!(dec_vec(c))).collect())
        } else {
            Value::Null
        }
    };
    let dump_col_digests = |columns: &Vec<Vec<F>>| -> Value {
        Value::Array(columns.iter().map(|c| json!(col_digest(c))).collect())
    };

    let mut obj = Map::new();
    obj.insert("fixture".into(), json!(name));
    obj.insert("lambda".into(), json!(DEFAULT_SECURITY_LEVEL));
    obj.insert(
        "dims".into(),
        json!({"m": m, "k": k, "n": n, "t": t}),
    );
    obj.insert(
        "vars".into(),
        json!(vars
            .iter()
            .map(|(i, f)| json!([i, dec(f)]))
            .collect::<Vec<_>>()),
    );
    obj.insert("u_root_hex".into(), json!(hex::encode(&proof.u_root)));
    obj.insert(
        "fs".into(),
        json!({
            "seed_r_interleaved_hex": hex::encode(&seed_r_interleaved),
            "r_interleaved_first8_dec": dec_vec(&r_interleaved[..r_interleaved.len().min(8)]),
            "preenc_u_lc_dec": dec_vec(&proof.interleaved_proof.preenc_u_lc),
            "seed_idx_interleaved_hex": hex::encode(&seed_idx_interleaved),
            "idx_interleaved": idx_interleaved,
            "seed_r_linear_hex": hex::encode(&seed_r_linear),
            "r_linear_first8_dec": dec_vec(&r_linear[..r_linear.len().min(8)]),
            "r_linear_last_dec": dec(&r_linear[r_linear.len() - 1]),
            "q_coeffs_dec": dec_vec(&proof.linear_constraints_proof.polynomial.coeffs),
            "seed_idx_linear_hex": hex::encode(&seed_idx_linear),
            "idx_linear": idx_linear,
            "seed_r_quadratic_hex": hex::encode(&seed_r_quadratic),
            "r_quadratic_first8_dec": dec_vec(&r_quadratic[..r_quadratic.len().min(8)]),
            "p0_coeffs_dec": dec_vec(&proof.quadratic_constraints_proof.polynomial.coeffs),
            "seed_idx_quadratic_hex": hex::encode(&seed_idx_quadratic),
            "idx_quadratic": idx_quadratic,
        }),
    );
    obj.insert(
        "interleaved_columns".into(),
        dump_columns(&proof.interleaved_proof.columns),
    );
    obj.insert(
        "interleaved_col_digests_hex".into(),
        dump_col_digests(&proof.interleaved_proof.columns),
    );
    obj.insert(
        "linear_columns".into(),
        dump_columns(&proof.linear_constraints_proof.columns),
    );
    obj.insert(
        "linear_col_digests_hex".into(),
        dump_col_digests(&proof.linear_constraints_proof.columns),
    );
    obj.insert(
        "quadratic_columns".into(),
        dump_columns(&proof.quadratic_constraints_proof.columns),
    );
    obj.insert(
        "quadratic_col_digests_hex".into(),
        dump_col_digests(&proof.quadratic_constraints_proof.columns),
    );
    // First auth path of the interleaved opening (structure check: ark
    // root-side-first layout, leaf sibling, leaf_index)
    if let Some(p) = proof.interleaved_proof.paths.first() {
        obj.insert(
            "first_path".into(),
            json!({
                "leaf_index": p.leaf_index,
                "leaf_sibling_hex": hex::encode(&p.leaf_sibling_hash),
                "auth_path_hex": p
                    .auth_path
                    .iter()
                    .map(hex::encode)
                    .collect::<Vec<_>>(),
            }),
        );
    }

    // Last: verify consumes the proof.
    assert!(
        ligero.verify(proof, &mt_params, &mut sponge.clone()),
        "reference self-verify failed for {name}"
    );
    Value::Object(obj)
}

// Fixture reconstructions (reference src/arithmetic_circuit/tests.rs:17-105;
// the originals live in a #[cfg(test)] module and are not exported, so the
// harness rebuilds them through the identical public builder calls).

fn bls12_377_circuit() -> ArithmeticCircuit<FqBLS> {
    let mut c = ArithmeticCircuit::new();
    let one = c.constant(FqBLS::ONE);
    let x = c.new_variable_with_label("x");
    let y = c.new_variable_with_label("y");
    let y2 = c.pow(y, 2);
    let m_y2 = c.minus(y2);
    let x3 = c.pow(x, 3);
    c.add_nodes([x3, one, m_y2, one]);
    c
}

fn lemniscate_circuit() -> ArithmeticCircuit<FrBN> {
    let mut c = ArithmeticCircuit::new();
    let one = c.constant(FrBN::ONE);
    let x = c.new_variable();
    let y = c.new_variable();
    let a = c.constant(FrBN::from(120u64));
    let b = c.constant(FrBN::from(80u64));
    let x2 = c.mul(x, x);
    let y2 = c.mul(y, y);
    let ax2 = c.mul(a, x2);
    let by2 = c.mul(b, y2);
    let m_ax2 = c.minus(ax2);
    let s = c.add(x2, y2);
    let d = c.add(by2, m_ax2);
    let s2 = c.mul(s, s);
    c.add_nodes([s2, d, one]);
    c
}

fn main() {
    let outdir = PathBuf::from(
        std::env::args()
            .nth(1)
            .unwrap_or_else(|| "../../tests/golden".to_string()),
    );
    fs::create_dir_all(&outdir).unwrap();

    write_json(&outdir, "sponge_probes_bn254.json", &sponge_probes::<FrBN>("bn254_fr"));
    write_json(&outdir, "sponge_probes_bls377.json", &sponge_probes::<FqBLS>("bls12_377_fq"));
    write_json(&outdir, "calculate_t.json", &calculate_t_grid());
    write_json(&outdir, "prng_streams.json", &prng_streams());

    // circom fixtures (paths are into the patched reference copy)
    let cir = |f: &str| format!("ligero-src/circom/{f}");
    write_json(
        &outdir,
        "r1cs_poseidon.json",
        &r1cs_rows(&cir("poseidon/poseidon.r1cs"), &cir("poseidon/poseidon_js/poseidon.wasm")),
    );
    write_json(
        &outdir,
        "r1cs_cube.json",
        &r1cs_rows(&cir("cube.r1cs"), &cir("cube.wasm")),
    );
    write_json(
        &outdir,
        "r1cs_multiplication.json",
        &r1cs_rows(&cir("multiplication.r1cs"), &cir("multiplication.wasm")),
    );

    // Proof-level captures.  lemniscate: vars (8, 4) per reference
    // src/ligero/tests.rs:197-201; output = circuit.last() as in
    // proof_and_verify (src/ligero/tests.rs:144-150).
    let lem = lemniscate_circuit();
    let lem_out = lem.last();
    let mut v = capture_proof(
        "lemniscate",
        lem,
        vec![lem_out],
        vec![(1, FrBN::from(8u64)), (2, FrBN::from(4u64))],
        true,
    );
    v["field"] = json!("bn254_fr");
    write_json(&outdir, "proof_lemniscate.json", &v);

    // bls12_377: a random curve point from ark_std::test_rng(), like
    // src/ligero/tests.rs:189-193 (values are dumped into the JSON).
    let Affine { x, y, .. } = G1Affine::rand(&mut test_rng());
    let bls = bls12_377_circuit();
    let bls_out = bls.last();
    let mut v = capture_proof(
        "bls12_377",
        bls,
        vec![bls_out],
        vec![(1, x), (2, y)],
        true,
    );
    v["field"] = json!("bls12_377_fq");
    write_json(&outdir, "proof_bls12_377.json", &v);

    // poseidon (reference src/ligero/tests.rs:364-415)
    let cs = read_constraint_system::<FrBN>(
        &cir("poseidon/poseidon.r1cs"),
        &cir("poseidon/poseidon_js/poseidon.wasm"),
    );
    let (circuit, outputs) = ArithmeticCircuit::from_constraint_system(&cs);
    let witness: Vec<FrBN> = serde_json::from_str::<Vec<String>>(
        &fs::read_to_string(cir("poseidon/witness.json")).unwrap(),
    )
    .unwrap()
    .iter()
    .map(|s| FrBN::from_str(s).unwrap())
    .collect();
    let vars: Vec<(usize, FrBN)> = witness.into_iter().enumerate().skip(1).collect();
    let mut v = capture_proof("poseidon", circuit, outputs, vars, false);
    v["field"] = json!("bn254_fr");
    write_json(&outdir, "proof_poseidon.json", &v);

    println!("capture complete");
}
